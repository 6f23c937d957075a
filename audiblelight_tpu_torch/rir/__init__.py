"""RIR engines: the analytic shoebox image sources and the stochastic mesh
ray tracer (counterpart of audiblelight_tpu/rir/). Both give IR banks
shaped (n_channels, n_emitters, ir_len) as tensors on the caller's device."""

from audiblelight_tpu_torch.rir.image_source import shoebox_rirs
from audiblelight_tpu_torch.rir.materials import MATERIALS, get_material_absorption, material_names
from audiblelight_tpu_torch.rir.sh import foa_encoding_gains, sh_real

__all__ = [
    "shoebox_rirs",
    "sh_real",
    "foa_encoding_gains",
    "MATERIALS",
    "material_names",
    "get_material_absorption",
]
