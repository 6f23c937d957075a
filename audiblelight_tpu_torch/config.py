"""Constants of the ported render path (values as in audiblelight_tpu.config)."""

SAMPLE_RATE = 44100
FFT_SIZE = 512
WIN_SIZE = 256
HOP_SIZE = 128
SPEED_OF_SOUND = 343.0

MAX_IR_SECONDS = 1.0
RAY_TRACER_DIRECT_RAY_COUNT = 500
RAY_TRACER_INDIRECT_RAY_COUNT = 5000
RAY_TRACER_INDIRECT_RAY_DEPTH = 200
RAY_TRACER_DIRECT_SH_ORDER = 3
RAY_TRACER_INDIRECT_SH_ORDER = 1
RAY_TRACER_FREQUENCY_BANDS = 4

# CUDA tensors go through the hand-written kernels (ops/cuda_kernels.py).
# With False a CUDA tensor raises instead: there is no silent plain route on
# the card (the plain versions are called by name where a comparison needs them).
USE_CUDA_KERNELS = True

# Meshes at or above this face count get an acoustic LOD for the multi-bend
# diffraction graph legs (worldstate.mesh_backend.MeshDeviceState).
GRID_ACCEL_MIN_FACES = 16384
# Face budget of the vertex-clustered acoustic LOD when the engine config's
# `mesh_simplification` is True.
MESH_SIMPLIFICATION_TARGET_FACES = 4096
