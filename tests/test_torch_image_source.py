"""The port's image-source engine (rir/image_source.py) against the JAX one.

The same numpy inputs (rooms, sources, listeners and absorption drawn from
a seed) go through both `shoebox_rirs` on the CPU. The image grid and the
log-betas are identical. The IRs are held within 1e-4 of the reference's
peak (max-abs, relative), for every encoding at orders 1-4 and 2,048-8,192
samples. 1e-5 is below the float32 noise of the algorithm itself: against
a float64 evaluation of the same sums, the reference's own IRs are off by
1.0e-5 to 3.2e-5 of peak and the port's by as much (the image distances'
rounding, which XLA contracts into multiply-adds and eager PyTorch does not,
moves every delay by ~1e-4 samples). Each case prints its measured gap;
the worst seen on the CPU was 3.4e-5. The blocks the port takes the images
and emitters in change only the sums' order (1e-6 of peak).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.rir import image_source as jis
from audiblelight_tpu_torch.rir import image_source as tis
from audiblelight_tpu_torch.utils import irfft_real

torch.set_num_threads(1)

SR = 24000
ROOM = np.array([6.0, 4.5, 3.0], np.float32)


def _inputs(seed, n_src, n_lis, n_bands):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.5, ROOM - 0.5, (n_src, 3)).astype(np.float32)
    lis = rng.uniform(0.5, ROOM - 0.5, (n_lis, 3)).astype(np.float32)
    log_beta, bands = jis.wall_log_betas_from_absorption(rng.uniform(0.1, 0.6, (6, n_bands)))
    return src, lis, log_beta, bands


def _both(src, lis, log_beta, bands, n_samples, order, encoding, room=ROOM, **kw):
    want = np.asarray(jis.shoebox_rirs(jnp.asarray(room), jnp.asarray(src), jnp.asarray(lis), jnp.asarray(log_beta),
                                       jnp.asarray(bands), n_samples=n_samples, max_order=order, sr=SR,
                                       encoding=encoding))
    got = tis.shoebox_rirs(room, src, lis, log_beta, bands, n_samples=n_samples, max_order=order, sr=SR,
                           encoding=encoding, device="cpu", **kw)
    return got, want


def _gap(got, want) -> float:
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("order", [0, 1, 4, 12])
def test_image_grid_identical(order):
    for got, want in zip(tis._image_grid(order), jis._image_grid(order)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("absorption,n_bands", [
    (0.3, 1), (0.3, 4), (np.linspace(0.1, 0.6, 6), 3), (np.random.default_rng(0).uniform(0, 1, (6, 5)), 1),
], ids=["scalar", "scalar-4-bands", "per-wall", "per-wall-per-band"])
def test_wall_log_betas_identical(absorption, n_bands):
    got = tis.wall_log_betas_from_absorption(absorption, n_bands=n_bands)
    want = jis.wall_log_betas_from_absorption(absorption, n_bands=n_bands)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("encoding,n_lis,n_src,n_bands,order,n_samples", [
    ("omni", 3, 3, 1, 1, 2048),
    ("omni", 3, 3, 4, 4, 4096),
    ("omni", 4, 2, 4, 2, 8192),
    ("foa", 1, 3, 4, 3, 8192),
    ("foa", 1, 2, 1, 1, 2048),
    ("sh2", 1, 3, 1, 2, 4096),
    ("sh3", 1, 3, 4, 4, 2048),
    ("binaural", 1, 3, 4, 2, 8192),
    ("binaural", 1, 2, 1, 4, 2048),
])
def test_shoebox_rirs_match_reference(encoding, n_lis, n_src, n_bands, order, n_samples):
    src, lis, log_beta, bands = _inputs(order * 10 + n_bands, n_src, n_lis, n_bands)
    got, want = _both(src, lis, log_beta, bands, n_samples, order, encoding)
    gap = _gap(got, want)
    print(f"{encoding} order {order}, {n_samples} samples, {n_bands} bands: max |diff| / peak {gap:.2e}")
    assert gap <= 1e-4


def test_images_straddling_the_ir_end():
    """A 2,048-sample IR (29.3 m at 343 m/s) in the order-4 cube (images out
    to 52 m) keeps the images whose delay lies before sample 2,047 (22 % of
    them here) and drops the others; the nearest image sits 0.024 samples
    from that edge, two orders above either package's rounding of a delay
    (~1e-4 samples), so both keep the same ones."""
    src, lis, log_beta, bands = _inputs(3, 2, 2, 4)
    n, q = jis._image_grid(4)
    img = (1 - 2 * q)[None] * src[:, None].astype(np.float64) + 2.0 * n[None] * ROOM
    delay = np.linalg.norm(img[None] - lis[:, None, None], axis=-1) * (SR / 343.0)
    kept = delay < 2047
    assert 0.2 < kept.mean() < 0.8 and np.abs(delay - 2047).min() > 0.01
    got, want = _both(src, lis, log_beta, bands, 2048, 4, "omni")
    assert _gap(got, want) <= 1e-4


def test_result_does_not_depend_on_the_blocks(monkeypatch):
    """Images one at a time, 7 at a time, the emitters one at a time (a
    budget that fits a single emitter) and the default blocks: the same IRs
    to 1e-6 of peak."""
    src, lis, log_beta, bands = _inputs(5, 3, 2, 4)
    ref = tis.shoebox_rirs(ROOM, src, lis, log_beta, bands, n_samples=2048, max_order=2, sr=SR, device="cpu")
    one = 2 * 1025 * 7 * tis.TERM_BYTES_DEFAULT  # 7 images of one emitter
    assert tis.block_shape(2, 3, 1025, 1000, "omni", None, tis.CPU_LIVE_BYTES) == (3, 1000)
    assert tis.block_shape(2, 3, 1025, 1000, "omni", 7, one) == (1, 7)
    for chunk, budget in ((1, tis.CPU_LIVE_BYTES), (7, tis.CPU_LIVE_BYTES), (7, one)):
        monkeypatch.setattr(tis, "CPU_LIVE_BYTES", budget)
        got = tis.shoebox_rirs(ROOM, src, lis, log_beta, bands, n_samples=2048, max_order=2, sr=SR, device="cpu",
                               chunk=chunk)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6, (chunk, budget)


def test_hrtf_and_a_missing_card_raise(monkeypatch):
    """An `hrtf` that is not an HRTFSet raises TypeError (measured sets are
    held to the reference in test_torch_hrtf.py); numpy inputs without a
    device run on the card, and raise where there is none."""
    src, lis, log_beta, bands = _inputs(1, 1, 1, 1)
    with pytest.raises(TypeError, match="HRTFSet"):
        tis.shoebox_rirs(ROOM, src, lis, log_beta, bands, n_samples=256, encoding="binaural", hrtf=object(),
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tis.shoebox_rirs(ROOM, src, lis, log_beta, bands, n_samples=256)
    got = tis.shoebox_rirs(torch.as_tensor(ROOM), torch.as_tensor(src), lis, log_beta, bands, n_samples=256)
    assert got.device.type == "cpu" and got.shape == (1, 1, 256)


@pytest.mark.parametrize("n", [2048, 2401])
def test_irfft_real_drops_dc_and_nyquist_imaginary_parts(n):
    """The engine's irfft is numpy's (and the CPU's): the imaginary parts of
    the DC and Nyquist bins, which a linear-phase spectrum has, play no part
    (cuFFT would read them on the card)."""
    rng = np.random.default_rng(n)
    spec = rng.standard_normal((3, n // 2 + 1)) + 1j * rng.standard_normal((3, n // 2 + 1))
    got = irfft_real(torch.from_numpy(spec.astype(np.complex64)), n)
    np.testing.assert_allclose(got.numpy(), np.fft.irfft(spec, n=n), rtol=0, atol=1e-6)
    assert torch.equal(got, torch.fft.irfft(torch.from_numpy(spec.astype(np.complex64)), n=n))
