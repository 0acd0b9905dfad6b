"""The plain reference of the multichannel chains the benchmark measures.

Straight from the equations, in plain PyTorch on whatever device the
tensors lie on, in float64 (``Chain(cfg, device)``) or, for the control,
in float32 with TF32 matrix products (``Chain(cfg, device, control=True)``).
It reads the configuration's own file (``benchmark/configs/<name>.json``)
and recomputes everything from it: mic positions, windows, steering phases,
TDOAs.  It imports nothing of the program under test.

Conventions (the chains' published semantics):

  * a plane wave from azimuth theta reaches mic c with delay
    t_c = -(r_c . u(theta)) / c_sound, u = (cos theta, sin theta);
  * frames of N samples every hop, windowed by the periodic square-root
    Hann window (analysis and synthesis), spectra X = rfft(frame * win);
    the stream is prefixed by the N - hop samples carried from before;
  * SRP-PHAT: P(m, g) = sum over pairs i < j and bins f of
    Re(G / (|G| + eps) * exp(+j omega_f (t_i - t_j)(theta_g))),
    G = X_i conj(X_j);
  * covariance after each block: R <- lam^T R + (1 - lam) sum_t
    lam^(T-1-t) x_t x_t^H; MVDR weights w = Rl^-1 d / (d^H Rl^-1 d) with
    Rl = R + delta tr(R) / C I and d_c = exp(-j omega t_c(theta));
  * output Y = w^H X, resynthesised by irfft, the synthesis window and
    overlap-add, with the N - hop samples still open carried on.

The control computes every matrix product (the steered power, the
covariance, the beamform) as TF32 does: each operand rounded to TF32's 10
mantissa bits, the products summed in float32.  The rounding is made
explicit (``tf32``), so that it holds whichever kernel the library picks:
cuBLAS takes no tensor-core path for small batched products.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


def positions(array: dict) -> np.ndarray:
    """Mic positions [C, 2] in metres from the configuration's array."""
    c = array["num_mics"]
    if array["kind"] == "circular":
        ang = 2.0 * np.pi * np.arange(c) / c
        return np.stack([array["radius"] * np.cos(ang),
                         array["radius"] * np.sin(ang)], axis=-1)
    if array["kind"] == "linear":
        x = (np.arange(c) - (c - 1) / 2.0) * array["spacing"]
        return np.stack([x, np.zeros_like(x)], axis=-1)
    return np.asarray(array["positions"], np.float64)[:, :2]


def mic_delays(array: dict, azimuths_rad) -> np.ndarray:
    """Arrival delay of each mic in seconds, [G, C]."""
    az = np.asarray(azimuths_rad, np.float64)
    u = np.stack([np.cos(az), np.sin(az)], axis=-1)
    return -(u @ positions(array).T) / array["speed_of_sound"]


def azimuth_grid(points: int) -> np.ndarray:
    """The candidate azimuths: -180 deg up to 180, endpoint excluded."""
    return np.deg2rad(np.linspace(-180.0, 180.0, points, endpoint=False))


def sqrt_hann(n: int) -> np.ndarray:
    """Periodic square-root Hann window in float64."""
    return np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n))


@contextlib.contextmanager
def full_precision():
    """Matrix products in the operands' own precision (no TF32)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) values rounded to TF32: 10 mantissa bits,
    to nearest, ties to even."""
    if x.is_complex():
        return torch.complex(tf32(x.real), tf32(x.imag))
    i = x.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


class Chain:
    """The stages of a block of the chain, from one configuration file."""

    def __init__(self, cfg: dict, device, control: bool = False):
        c = cfg["config"]
        self.control = control
        self.real = torch.float32 if control else torch.float64
        self.cplx = torch.complex64 if control else torch.complex128
        self.device = torch.device(device)
        arr, st, algo = c["array"], c["stft"], c["algo"]
        self.fs = float(c["sample_rate"])
        self.block_len = c["block_len"]
        self.n, self.hop = st["frame_len"], st["hop"]
        self.t = self.block_len // self.hop
        self.f = self.n // 2 + 1
        self.c = arr["num_mics"]
        self.g = algo["grid_points"]
        self.lam = algo["cov_forget"]
        self.delta = algo["diag_load"]
        self.eps = algo["phat_eps"]
        self.sources = algo["num_sources"]
        self.smooth = algo["track_smooth"]
        self.suppress = max(1, int(round(algo["peak_suppression_deg"]
                                         / (360.0 / self.g))))
        pairs = np.array([(i, j) for i in range(self.c)
                          for j in range(i + 1, self.c)])
        self.pairs = torch.from_numpy(pairs).to(self.device)
        self.p = len(pairs)
        az = azimuth_grid(self.g)
        self.az = torch.from_numpy(az).to(self.device)
        # the program's grid as float32, for reading its answers
        self.az32 = torch.from_numpy(az.astype(np.float32)).to(self.device)
        omega = 2.0 * np.pi * self.fs * np.arange(self.f) / self.n
        t = mic_delays(arr, az)                                   # [G, C]
        tau = t[:, pairs[:, 0]] - t[:, pairs[:, 1]]                # [G, P]
        phase = omega[None, :, None] * tau.T[:, None, :]          # [P, F, G]
        put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, dt)
        self.cos = put(np.cos(phase).reshape(self.p * self.f, self.g),
                       self.real)
        self.sin = put(np.sin(phase).reshape(self.p * self.f, self.g),
                       self.real)
        steer = -omega[None, None, :] * t[:, :, None]             # [G, C, F]
        self.steer = torch.complex(put(np.cos(steer), self.real),
                                   put(np.sin(steer), self.real))
        self.win = put(sqrt_hann(self.n), self.real)
        if control:
            self.cos, self.sin = tf32(self.cos), tf32(self.sin)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a matrix product: TF32 in the control."""
        return tf32(x) if self.control else x

    def cmatmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = self.operand(a), self.operand(b)
        ar, ai, br, bi = a.real, a.imag, b.real, b.imag
        with full_precision():
            return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)

    # ---- analysis ------------------------------------------------------
    def spectra(self, blocks: torch.Tensor, carry: torch.Tensor):
        """blocks [B, C, L], carry [C, N - hop] -> (X [C, B*T, F], the
        stream's last N - hop samples)."""
        b = blocks.shape[0]
        flat = blocks.to(self.real).permute(1, 0, 2).reshape(self.c, -1)
        x = torch.cat([carry.to(self.real), flat], dim=-1)
        frames = x.unfold(-1, self.n, self.hop)                   # [C, BT, N]
        assert frames.shape[1] == b * self.t
        return (torch.fft.rfft(frames * self.win, dim=-1),
                x[:, x.shape[-1] - (self.n - self.hop):].clone())

    def surfaces(self, spec: torch.Tensor) -> torch.Tensor:
        """SRP-PHAT power of every frame, [M, G], in chunks of frames."""
        m = spec.shape[1]
        chunk = max(1, (1 << 30) // (self.p * self.f * 16))
        out = []
        with full_precision():
            for s in range(0, m, chunk):
                xs = spec[:, s:s + chunk]                          # [C, m, F]
                g = xs[self.pairs[:, 0]] * torch.conj(xs[self.pairs[:, 1]])
                g = g / (g.abs() + self.eps)                       # [P, m, F]
                g = self.operand(g.permute(1, 0, 2).reshape(g.shape[1], -1))
                out.append(g.real @ self.cos - g.imag @ self.sin)
        return torch.cat(out)

    # ---- covariance and MVDR -------------------------------------------
    def cov_prefixes(self, spec: torch.Tensor, cov0: torch.Tensor
                     ) -> torch.Tensor:
        """The covariance after each block, [B, F, C, C]."""
        t = self.t
        b = spec.shape[1] // t
        x = spec.view(self.c, b, t, self.f).permute(1, 3, 0, 2)   # [B,F,C,T]
        k = torch.arange(t, device=self.device, dtype=torch.float64)
        w = ((1.0 - self.lam) * self.lam ** (t - 1 - k)).to(self.real)
        q = self.cmatmul(x * w, torch.conj(x).transpose(-1, -2))  # [B,F,C,C]
        decay = self.lam ** t
        r = cov0.to(self.cplx)
        out = []
        for i in range(b):
            r = decay * r + q[i]
            out.append(r)
        return torch.stack(out)

    def weights(self, covs: torch.Tensor, steer: torch.Tensor) -> torch.Tensor:
        """MVDR weights [B, S, C, F] from covariances [B, F, C, C] and
        steering vectors [B, S, C, F]."""
        tr = torch.diagonal(covs, dim1=-2, dim2=-1).sum(-1).real / self.c
        eye = torch.eye(self.c, device=self.device, dtype=self.cplx)
        loaded = covs + (self.delta * tr)[..., None, None] * eye
        d = steer.permute(0, 3, 2, 1)                             # [B,F,C,S]
        y = torch.linalg.solve(loaded, d)
        norm = (torch.conj(d) * y).sum(dim=-2, keepdim=True)      # [B,F,1,S]
        return (y / norm).permute(0, 3, 2, 1)

    def beamform(self, spec: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Y = w^H X per block and source: [B, S, T, F]."""
        b = w.shape[0]
        x = spec.view(self.c, b, self.t, self.f).transpose(0, 1)  # [B,C,T,F]
        with full_precision():
            return torch.einsum("bscf,bctf->bstf",
                                self.operand(torch.conj(w)), self.operand(x))

    # ---- synthesis -----------------------------------------------------
    def synthesis(self, y: torch.Tensor, tail: torch.Tensor):
        """y [B, S, T, F], tail [S, N - hop] -> (audio [B, S, T*hop], new
        tail [S, N - hop]): overlap-add over the whole frame stream."""
        b, s = y.shape[:2]
        frames = torch.fft.irfft(y, n=self.n, dim=-1) * self.win  # [B,S,T,N]
        frames = frames.transpose(0, 1).reshape(s, b * self.t, self.n)
        m, k = b * self.t, self.n // self.hop
        full = frames.new_zeros((s, m + k - 1, self.hop))
        slabs = frames.view(s, m, k, self.hop)
        for j in range(k):
            full[:, j:j + m] += slabs[:, :, j]
        full = full.reshape(s, -1)
        full[:, :self.n - self.hop] += tail.to(self.real)
        audio = full[:, :m * self.hop].reshape(s, b, self.t * self.hop)
        return audio.transpose(0, 1), full[:, m * self.hop:].clone()

    def init_state(self, tracked: bool) -> dict:
        """The state a stream starts from: nothing carried, the covariance
        a small identity (1e-6 I), tracks unset (angle and confidence 0)."""
        lh = self.n - self.hop
        s = self.sources if tracked else 1
        z = lambda *shape: torch.zeros(shape, dtype=self.real,
                                       device=self.device)
        st = {"carry": z(self.c, lh), "tail": z(s, lh),
              "cov": 1e-6 * torch.eye(self.c, dtype=self.cplx,
                                      device=self.device).expand(
                                          self.f, self.c, self.c).clone()}
        if tracked:
            st.update(angles=z(s), confidence=z(s),
                      initialized=torch.zeros(s, dtype=torch.bool,
                                              device=self.device))
        return st

    # ---- reading the program's answers ---------------------------------
    def grid_index(self, azimuths: torch.Tensor) -> torch.Tensor:
        """The grid point of each azimuth the program gave, by float32
        equality with the grid; -1 where none is equal."""
        a = azimuths.to(self.device, torch.float32)
        hit = a[..., None] == self.az32
        return torch.where(hit.any(-1), hit.to(torch.int32).argmax(-1),
                           torch.full_like(a, -1, dtype=torch.long))


def bad_picks(power: torch.Tensor, picks: torch.Tensor, tie: float
              ) -> torch.Tensor:
    """How many picks [...] on surfaces [..., G] are no maximum: a pick
    whose power lies below the surface's best by more than ``tie`` of the
    surface's largest magnitude (a tie at the program's precision), or no
    grid point at all (-1)."""
    best = power.max(dim=-1).values
    scale = power.abs().max(dim=-1).values
    got = torch.gather(power, -1, picks.clamp(min=0)[..., None])[..., 0]
    return ((picks < 0) | (got < best - tie * scale)).sum()


def rel_l2(got: torch.Tensor, want: torch.Tensor, dims) -> float:
    """Largest ||got - want|| / ||want|| over the axes not in ``dims``."""
    got = got.to(want.dtype)
    num = torch.linalg.vector_norm(got - want, dim=dims)
    den = torch.linalg.vector_norm(want, dim=dims)
    return float((num / den).max())


def wrap(a):
    """Angles wrapped to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def state_err(got: dict, want: dict) -> float:
    """The widest gap between two states, field by field: relative to the
    field's largest magnitude, or absolute where that is 0."""
    errs = []
    for k, w in want.items():
        g = got[k]
        if w.dtype == torch.bool:
            errs.append(float((g != w).any()))
            continue
        scale = float(w.abs().max())
        g = g.to(w.dtype)
        errs.append(float((g - w).abs().max()) / (scale or 1.0))
    return max(errs)
