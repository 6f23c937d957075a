"""audiblelight_tpu_torch: the PyTorch/CUDA port of audiblelight_tpu.

Spatial soundscape synthesis on an NVIDIA card: place static and moving
sound events and microphone arrays in 3D rooms (ray-traced meshes,
parametric shoebox rooms or measured SOFA RIRs), render multichannel
spatial audio, and write DCASE-format SELD annotations, acoustic images
and video. The same front door as the reference:

    from audiblelight_tpu_torch import Scene

The ray tracer's first-hit, any-hit and deposit-histogram kernels are
hand-written CUDA for Hopper (`csrc/`), each beside a plain PyTorch version
of the same function (`ops/cuda_kernels.py`); they are built on their first
launch, never on import. Entry points run on `cuda` unless the caller passes
`device="cpu"`; they never fall back to the CPU on their own.
"""

__version__ = "0.1.0"

from audiblelight_tpu_torch.ambience import Ambience
from audiblelight_tpu_torch.core import Scene
from audiblelight_tpu_torch.event import Event
from audiblelight_tpu_torch.micarrays import MicArray
from audiblelight_tpu_torch.worldstate import WorldState

__all__ = ["Scene", "Event", "Ambience", "MicArray", "WorldState", "__version__"]
