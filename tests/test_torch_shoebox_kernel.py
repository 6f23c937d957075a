"""The shoebox image-source kernel (csrc/shoebox_ism.cu) and its plain
version, the eager block loop (`rir.image_source.shoebox_rirs_plain`).

On the CPU (these count everywhere): the per-image quantities the kernel
reads (`image_terms` over all images at once, and the receiver gains) equal
the block loop's own, bit for bit; the kernel's integer phase method equals
the reference's split formula for every bin and every delay; the CPU engine
launches nothing and returns the bits it returned before the kernel existed.

On the card (marked `cuda`, each skips without one): the kernel against the
block loop on the card for omni (4 capsules), FOA and sh1-sh3, orders 1, 4
and 12, 1 and 4 bands, even and odd IR lengths, images on both sides of the
IR's end: within 1e-5 of the IRs' peak (the bound the card already meets
against the CPU), the same bits from two calls, two launches a call; a
binaural call launches none. The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_shoebox_kernel.py -m cuda
"""

import hashlib

import numpy as np
import pytest
import torch

from audiblelight_tpu_torch.ops import cuda_kernels as ck
from audiblelight_tpu_torch.rir import image_source as tis

SR = 24000
ROOM = np.array([6.0, 4.5, 3.0], np.float32)


def _inputs(seed, n_src, n_lis, n_bands):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.5, ROOM - 0.5, (n_src, 3)).astype(np.float32)
    lis = rng.uniform(0.5, ROOM - 0.5, (n_lis, 3)).astype(np.float32)
    log_beta, bands = tis.wall_log_betas_from_absorption(rng.uniform(0.1, 0.6, (6, n_bands)))
    return src, lis, log_beta, bands


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("encoding,n_lis", [("omni", 4), ("foa", 1), ("sh3", 1)])
def test_image_terms_are_the_block_loops_own(monkeypatch, encoding, n_lis):
    """The quantities the kernel reads, formed over all images at once,
    equal what the block loop forms block by block (7 images at a time,
    one emitter a block): amp, d_frac, d_mod and the receiver gains."""
    src, lis, log_beta, bands = _inputs(11, 3, n_lis, 4)
    blocks, gains = [], []
    real_terms, real_gains = tis.image_terms, tis.ambisonic_encoding_gains

    def terms(*args):
        out = real_terms(*args)
        blocks.append(out)
        return out

    def enc(*args):
        out = real_gains(*args)
        gains.append(out)
        return out

    monkeypatch.setattr(tis, "image_terms", terms)
    monkeypatch.setattr(tis, "ambisonic_encoding_gains", enc)
    one = n_lis * 1025 * 7 * tis.TERM_BYTES_DEFAULT  # 7 images of one emitter
    monkeypatch.setattr(tis, "CPU_LIVE_BYTES", one)
    tis.shoebox_rirs(ROOM, src, lis, log_beta, bands, n_samples=2048, max_order=2, sr=SR, encoding=encoding,
                     device="cpu", chunk=7)
    assert len(blocks) == 3 * -(-1000 // 7)

    f32 = dict(dtype=torch.float32)
    n, q = tis._image_grid(2)
    n, q = torch.as_tensor(n), torch.as_tensor(q)
    mirror, shift = (1 - 2 * q).to(torch.float32), (2.0 * n.to(torch.float32)) * torch.as_tensor(ROOM)
    lis_t = torch.as_tensor(lis, **f32)[: n_lis if encoding == "omni" else 1]
    vec, dist, amp, d_frac, d_mod = real_terms(torch.as_tensor(src, **f32), lis_t, mirror, shift, SR, 343.0, 2047,
                                               2048)
    # The loop runs emitter blocks outside image blocks: reassemble (R, E, K)
    per_e = -(-1000 // 7)
    for i, got in enumerate((amp, d_frac, d_mod)):
        want = torch.cat([torch.cat([b[2 + i] for b in blocks[e * per_e:(e + 1) * per_e]], dim=2)
                          for e in range(3)], dim=1)
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert d_mod.dtype == torch.int32
    if encoding != "omni":
        want = torch.cat([torch.cat(gains[e * per_e:(e + 1) * per_e], dim=1) for e in range(3)], dim=0)
        got = real_gains(tis.image_directions(vec, dist), 3, encoding)
        assert torch.equal(got, want) and bool((got[..., 0] == 1.0).all())


@pytest.mark.parametrize("n", [24000, 4801])
def test_kernel_phase_is_the_remainder(n):
    """The kernel's integer phase (`ism_phase_plain` mirrors its method)
    equals the reference's int32 split formula, ((((f d_hi) mod n) << 8) mod
    n + f d_lo) mod n, for every bin f of an n-sample IR and every delay
    d_mod in [0, n)."""
    f = torch.arange(n // 2 + 1, dtype=torch.int32)[None]
    for d0 in range(0, n, 1000):
        d = torch.arange(d0, min(n, d0 + 1000), dtype=torch.int32)[:, None]
        split = ((((f * (d >> 8)) % n) << 8) % n + f * (d & 255)) % n
        assert torch.equal(ck.ism_phase_plain(f, d, n), split.to(torch.int64)), d0


# sha256 of the CPU engine's float32 IRs, computed before the kernel existed
CPU_DIGESTS = {
    ("omni", 3, 2, 4, 2, 512): "a41b00da3e9d379553eb20fdcf4d018e4226d9af38e73d9436b7e426af3577ed",
    ("foa", 1, 3, 1, 3, 1023): "5216812886d1837cd9af6b5b9e6bb6fd6bbba3f41c631bf26aecad984a08dfb3",
    ("sh3", 1, 2, 4, 1, 256): "b0ba80eeb3fb9df5e52c1fb332c56a76366c1f3ff7328f8e6e3d35a83958d393",
    ("binaural", 1, 2, 4, 1, 256): "77b8478ea1c579b70549344cfa9c05d72998fcb0c64e31d900b780eb88f347b7",
}


@pytest.mark.parametrize("case", list(CPU_DIGESTS), ids=[c[0] for c in CPU_DIGESTS])
def test_cpu_engine_unchanged(one_thread, case):
    """On the CPU `shoebox_rirs` is the block loop: no kernel launch, and
    the same bits as before the kernel."""
    encoding, n_lis, n_src, n_bands, order, n = case
    src, lis, log_beta, bands = _inputs(order * 10 + n_bands, n_src, n_lis, n_bands)
    before = dict(ck.launch_counts)
    got = tis.shoebox_rirs(ROOM, src, lis, log_beta, bands, n_samples=n, max_order=order, sr=SR, encoding=encoding,
                           device="cpu")
    assert ck.launch_counts == before
    assert hashlib.sha256(got.numpy().tobytes()).hexdigest() == CPU_DIGESTS[case]


def test_splits_fill_whole_waves():
    """The cell's shape (FOA, 15 emitters: 2 path groups x 47 bin blocks,
    125,000 images) on 132 SMs of 2 resident blocks: 14 splits, 5 full
    waves; one split where a single wave holds every block; at most
    `max_splits`."""
    assert ck.ism_splits(94, 264, 125000, 93) == 14
    assert -(-94 * 14 // 264) == 5
    assert ck.ism_splits(10, 264, 216, 3) == 3
    assert ck.ism_splits(264, 264, 125000, 93) == 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        ck.shoebox_ism(torch.zeros((1, 8), dtype=torch.int32), torch.zeros((1, 8)), torch.zeros((1, 8)), None,
                       torch.zeros((8, 6)), torch.zeros((5, 6)), 8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_CASES = [
    # encoding, capsules, sources, bands, order, n_samples
    ("omni", 4, 6, 1, 1, 2048),
    ("omni", 4, 15, 4, 4, 2047),
    ("omni", 4, 5, 4, 12, 801),
    ("foa", 1, 15, 4, 12, 600),
    ("foa", 1, 6, 1, 4, 4096),
    ("foa", 1, 3, 4, 1, 1023),
    ("sh1", 1, 4, 4, 4, 2048),
    ("sh2", 1, 5, 1, 4, 1025),
    ("sh2", 1, 3, 4, 12, 700),
    ("sh3", 1, 7, 4, 4, 2048),
    ("sh3", 1, 2, 1, 12, 601),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=["-".join(map(str, c)) for c in CARD_CASES])
def test_kernel_matches_plain(card, case):
    """The kernel against the block loop on the card: within 1e-5 of the
    IRs' peak, bit-identical from call to call, two launches a call."""
    encoding, n_lis, n_src, n_bands, order, n = case
    src, lis, log_beta, bands = _inputs(order * 100 + n_src, n_src, n_lis, n_bands)
    # One source near a corner: its far images straddle the IR's end
    src[0] = [0.6, 0.7, 0.5]
    src_d = torch.as_tensor(src, device=card)
    kw = dict(n_samples=n, max_order=order, sr=SR, encoding=encoding)
    want = tis.shoebox_rirs_plain(ROOM, src_d, lis, log_beta, bands, **kw)
    ck.reset_launch_counts()
    got = tis.shoebox_rirs(ROOM, src_d, lis, log_beta, bands, **kw)
    again = tis.shoebox_rirs(ROOM, src_d, lis, log_beta, bands, **kw)
    torch.cuda.synchronize()
    assert ck.launch_counts["shoebox_ism"] == 4
    assert sum(ck.launch_counts.values()) == 4
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    gap = float((got - want).abs().max() / want.abs().max())
    print(f"{case}: max |kernel - plain| / peak {gap:.2e}")
    assert gap <= 1e-5
    # Images on both sides of the IR's end
    grid_n, grid_q = tis._image_grid(order)
    img = (1 - 2 * grid_q) * src[0].astype(np.float64) + 2.0 * grid_n * ROOM
    delay = np.linalg.norm(img[None] - lis[:1, None].astype(np.float64), axis=-1) * (SR / 343.0)
    if order > 1:
        assert 0.0 < (delay < n - 1).mean() < 1.0


@pytest.mark.cuda
def test_binaural_launches_no_kernel(card):
    """The analytic head keeps the block loop on the card."""
    src, lis, log_beta, bands = _inputs(3, 3, 1, 4)
    ck.reset_launch_counts()
    got = tis.shoebox_rirs(ROOM, torch.as_tensor(src, device=card), lis, log_beta, bands, n_samples=1024,
                           max_order=2, sr=SR, encoding="binaural")
    torch.cuda.synchronize()
    assert got.shape == (2, 3, 1024) and ck.launch_counts["shoebox_ism"] == 0
