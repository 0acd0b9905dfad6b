"""The arithmetic of kernel 3's card design (``csrc/covprefix.cu``), proven
on the CPU.

The CUDA kernels run only on the card, so these tests replay the design's
schedule in PyTorch and hold it to the kernel's plain version and to
``mcax``'s ``block_prefixes_rows`` (its Pallas kernel in interpret mode, as
``tests/unit/test_covprefix.py`` runs it) at the kernel's own bound,
atol = rtol = 2e-4: the blocks cut into the chunks of ``plan_chunks``; each
block's partial summed over its frames in frame order from zero, with the
frame weights made in float64 and rounded to fp32; the recursion within a
chunk from zero (chunk 0 from cov0); the carries
``carry_k = decay^L carry_{k-1} + local_end_k``; and the fix-up
``prefix_b = local_b + decay^(b-start+1) carry_{k-1}``, every power of decay
made by repeated fp32 multiplication from 1, as the kernels make them.
Cases: config4's and config5's channel counts, one block, a chunk length
that does not divide B, lam = 1 and a decay that underflows to 0, cov0
given and None.  And the planner: every block in exactly one chunk, at most
``MAX_CHUNKS`` chunks, and a grid that fills the 132 SMs of an H100 at
config4's and config5's B = 512.
"""

import jax
import numpy as np
import pytest
import torch

from mcax.kernels import covprefix as m_cov
from mcax_torch.kernels import covprefix

torch.set_num_threads(1)
SMS = 132                       # the H100 SXM's SMs


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("MCAX_BACKEND", "pallas")
    monkeypatch.setenv("MCAX_PALLAS_INTERPRET", "1")


def _pow(decay: torch.Tensor, n: int) -> torch.Tensor:
    """decay^n as the kernels make it: 1 * decay * decay ... in fp32."""
    p = torch.ones((), dtype=torch.float32)
    for _ in range(n):
        p = p * decay
    return p


def _scan_emulation(spectra, cov0, lam, t, length):
    """The three kernels' schedule in fp32: rows [B, 2C^2, F]."""
    c, m, f = spectra.shape
    b = m // t
    x = spectra.permute(1, 2, 0).reshape(b, t, f, c)       # [B, T, F, C]
    w = covprefix._frame_weights(lam, t, spectra.device)
    partials = torch.zeros((b, f, c, c), dtype=torch.complex64)
    for tt in range(t):                                    # frame order
        xi = x[:, tt] * w[tt]
        partials = partials + xi[..., :, None] * torch.conj(x[:, tt])[
            ..., None, :]
    decay = torch.tensor(lam ** t, dtype=torch.float32)
    chunks = -(-b // length)
    # 1. local prefixes, from zero within each chunk (chunk 0 from cov0)
    local = []
    for k in range(chunks):
        acc = (cov0 if k == 0 and cov0 is not None
               else torch.zeros_like(partials[0]))
        for bb in range(k * length, min((k + 1) * length, b)):
            acc = decay * acc + partials[bb]
            local.append(acc)
    rows = covprefix.complex_to_rows(torch.stack(local)).clone()
    # 2. carries over the chunks' last local prefixes
    pl = _pow(decay, length)
    carries = [rows[length - 1]]
    for k in range(1, chunks - 1):
        carries.append(pl * carries[-1] + rows[(k + 1) * length - 1])
    # 3. the fix-up of chunks 1..K-1
    for k in range(1, chunks):
        p = torch.ones((), dtype=torch.float32)
        for bb in range(k * length, min((k + 1) * length, b)):
            p = p * decay
            rows[bb] = rows[bb] + p * carries[k - 1]
    return rows


def _mcax_rows(spec, cov0, lam, t):
    @jax.jit
    def ref(sr, si, c0r, c0i):
        c0 = None if c0r is None else jax.lax.complex(c0r, c0i)
        rows, _ = m_cov.block_prefixes_rows(jax.lax.complex(sr, si), c0,
                                            lam, t)
        return rows

    f = spec.shape[-1]
    return np.asarray(ref(spec.real, spec.imag,
                          None if cov0 is None else cov0.real,
                          None if cov0 is None else cov0.imag))[:, :, :f]


def _case(c, b, t, f, seeded, seed=0):
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((c, b * t, f))
            + 1j * rng.standard_normal((c, b * t, f))).astype(np.complex64)
    cov0 = None
    if seeded:
        a = (rng.standard_normal((f, c, c))
             + 1j * rng.standard_normal((f, c, c))).astype(np.complex64)
        cov0 = (a + np.conj(np.swapaxes(a, -1, -2))).astype(np.complex64)
    return spec, cov0


@pytest.mark.parametrize("c,b,t,f,lam,seeded,length", [
    (8, 6, 24, 33, 0.95, True, 2),      # config4's C, T and lam; 3 chunks
    (8, 7, 24, 33, 0.95, False, 3),     # chunk length 3 does not divide 7
    (16, 5, 16, 17, 0.9, True, 2),      # config5's C, T and lam
    (16, 4, 16, 17, 0.9, False, 1),     # one block a chunk
    (8, 1, 24, 33, 0.95, True, 1),      # B = 1: one chunk, no fix-up
    (8, 5, 24, 33, 1.0, True, 2),       # lam = 1: decay 1, weights 0
    (3, 6, 16, 9, 1e-3, True, 4),       # decay underflows to 0
])
def test_scan_schedule_matches_plain_and_mcax(c, b, t, f, lam, seeded,
                                              length):
    spec_np, cov0_np = _case(c, b, t, f, seeded, seed=b + c)
    spec = torch.from_numpy(spec_np)
    cov0 = None if cov0_np is None else torch.from_numpy(cov0_np)
    got = _scan_emulation(spec, cov0, lam, t, length)
    plain = covprefix.block_prefixes_rows_plain(spec, cov0, lam, t)
    assert got.shape == plain.shape == (b, 2 * c * c, f)
    torch.testing.assert_close(got, plain, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), _mcax_rows(spec_np, cov0_np,
                                                       lam, t),
                               atol=2e-4, rtol=2e-4)
    if lam < 1e-2:
        assert np.float32(lam ** t) == 0     # the case is the underflow
    if lam == 1.0:       # every weight (1 - lam) = 0: each prefix is cov0
        want = covprefix.complex_to_rows(cov0.expand(b, -1, -1, -1))
        assert torch.equal(got, want)


def test_scan_schedule_at_the_planned_chunks():
    """config4's channels at the plan the wrapper takes for B = 37 on 132
    SMs of 3 CTAs each (every chunk one block long)."""
    c, b, t, f, lam = 8, 37, 24, 9, 0.95
    length, chunks = covprefix.plan_chunks(b, c, 513, 3 * SMS)
    assert chunks == -(-b // length)
    spec_np, cov0_np = _case(c, b, t, f, True, seed=4)
    spec, cov0 = torch.from_numpy(spec_np), torch.from_numpy(cov0_np)
    torch.testing.assert_close(
        _scan_emulation(spec, cov0, lam, t, length),
        covprefix.block_prefixes_rows_plain(spec, cov0, lam, t),
        atol=2e-4, rtol=2e-4)


def test_decay_powers_are_repeated_products():
    """The kernels' decay^n: exact at 1 and 0, the repeated fp32 product
    (within 1e-6 of the float64 power), and an underflow to 0."""
    d = torch.tensor(0.95 ** 24, dtype=torch.float32)
    assert _pow(d, 0) == 1 and _pow(d, 1) == d
    assert _pow(torch.ones((), dtype=torch.float32), 512) == 1
    assert _pow(torch.zeros((), dtype=torch.float32), 3) == 0
    for n in (2, 17, 64):
        assert abs(_pow(d, n).item() - float(d) ** n) <= 1e-6 * float(d) ** n
    assert _pow(torch.tensor(1e-20, dtype=torch.float32), 3) == 0


@pytest.mark.parametrize("c,bins", [(1, 32), (3, 32), (8, 32), (9, 16),
                                    (16, 16), (17, 8), (32, 8)])
def test_tile_bins(c, bins):
    assert covprefix.tile_bins(c) == bins


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [1, 2, 7, 37, 64, 65, 101, 500, 512, 1000])
def test_plan_chunks_covers_every_block_once(b, per_sm):
    length, chunks = covprefix.plan_chunks(b, 8, 513, per_sm * SMS)
    assert 1 <= length <= b and 1 <= chunks <= covprefix.MAX_CHUNKS
    assert chunks == -(-b // length)          # the kernels' own check
    starts = [k * length for k in range(chunks)]
    covered = [bb for s in starts for bb in range(s, min(s + length, b))]
    assert covered == list(range(b))


@pytest.mark.parametrize("c,f", [(8, 513), (16, 257)])
@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
def test_plan_fills_the_card_at_config4_and_config5(c, f, per_sm):
    """At B = 512 the grid is at least two waves of 132 SMs, and its last
    wave of ``per_sm`` CTAs an SM is at least 90 % full."""
    slots = per_sm * SMS
    length, chunks = covprefix.plan_chunks(512, c, f, slots)
    grid = -(-f // covprefix.tile_bins(c)) * chunks
    assert grid >= 2 * SMS
    assert grid / (-(-grid // slots) * slots) >= 0.9
