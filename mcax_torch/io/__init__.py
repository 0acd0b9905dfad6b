from mcax_torch.io.wav import read_wav, write_wav
