"""Device DSP primitives on tensors: STFT/iSTFT, time-invariant and
time-variant FFT convolution, IR normalisation and level scaling, and
colored noise (counterpart of audiblelight_tpu/ops/). The hand-written
kernels and their plain versions are in `cuda_kernels`."""

from audiblelight_tpu_torch.ops.convolve import (
    fft_convolve,
    interpolation_matrix,
    time_variant_convolve_spec,
    tv_convolve,
)
from audiblelight_tpu_torch.ops.noise import powerlaw_psd_gaussian
from audiblelight_tpu_torch.ops.scaling import (
    apply_snr,
    db_to_multiplier,
    normalize_irs,
    pad_or_truncate_audio,
    peak_normalize,
)
from audiblelight_tpu_torch.ops.stft import istft_overlap_add, stft

__all__ = [
    "stft",
    "istft_overlap_add",
    "fft_convolve",
    "tv_convolve",
    "time_variant_convolve_spec",
    "interpolation_matrix",
    "apply_snr",
    "db_to_multiplier",
    "normalize_irs",
    "peak_normalize",
    "pad_or_truncate_audio",
    "powerlaw_psd_gaussian",
]
