from mcax_torch.utils import checkpoint as checkpoint
from mcax_torch.utils import metrics as metrics
