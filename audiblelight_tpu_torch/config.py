"""Constants of the port (values as in audiblelight_tpu.config).

The two optional first-hit routes of the tracer's bounce loop,
USE_TILED_FIRST_HIT (K7) and USE_MXU_FIRST_HIT (K8), are off as in the
reference. The reference also requires a TPU for them; the port takes the
route a flag selects on every device, as it does the star any-hit: its plain
version on the CPU, its kernel on the card.
"""

SAMPLE_RATE = 44100

# Scene
DEFAULT_REF_DB = -65
MAX_OVERLAP = 2
WARN_WHEN_SCENE_DURATION_BELOW = 5

# Event
MIN_EVENT_VELOCITY, MAX_EVENT_VELOCITY = 0.5, 2.0
MIN_EVENT_RESOLUTION, MAX_EVENT_RESOLUTION = 1.0, 4.0
MIN_EVENT_DURATION, MAX_EVENT_DURATION = 2.0, 10.0
MIN_EVENT_SNR, MAX_EVENT_SNR = 5.0, 30.0
DEFAULT_EVENT_VELOCITY = (MAX_EVENT_VELOCITY - MIN_EVENT_VELOCITY) / 2
DEFAULT_EVENT_RESOLUTION = (MAX_EVENT_RESOLUTION - MIN_EVENT_RESOLUTION) / 2

# World state and placement
MESH_UNITS = "meters"
MIN_AVG_RAY_LENGTH = 3.0
NUM_RAYS = 100
POINT_BATCH_SIZE = 10
EMPTY_SPACE_AROUND_EMITTER = 0.2
EMPTY_SPACE_AROUND_MIC = 0.1
EMPTY_SPACE_AROUND_SURFACE = 0.2
EMPTY_SPACE_AROUND_CAPSULE = 0.05
WARN_WHEN_RAY_EFFICIENCY_BELOW = 0.5
MAX_PLACE_ATTEMPTS = 1000
MOVING_EVENT_SHAPES = ["random", "linear", "semicircular"]

# Dataset generation (SELD CLI defaults)
MIN_STATIC_EVENTS, MAX_STATIC_EVENTS = 1, 10
MIN_MOVING_EVENTS, MAX_MOVING_EVENTS = 0, 6
BUFFER_SIZE = 8192
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
# diffraction graph legs (worldstate.mesh_backend.MeshDeviceState), and, with
# USE_TILED_FIRST_HIT, a face tree for K7 when the full mesh is traced.
GRID_ACCEL_MIN_FACES = 16384

# Tiled first hit (ops/tiled_first_hit.py, K7) when the full mesh is traced:
# the dense classic Moller-Trumbore first hit (on the card a per-ray walk of
# the mesh's face tree, as K1's). Off by default as in the reference, which
# measured its TPU form (a block x tile cull) at par with its dense kernel.
USE_TILED_FIRST_HIT = False
# Bilinear first hit (ops/mxu_first_hit.py, K8) on meshes of at most
# MXU_F_MAX faces: its 2 % window slop lets a neighbouring face win near an
# edge, and its bf16 form on the TPU lost the decay time, so it stays off.
USE_MXU_FIRST_HIT = False

# Face budget of the vertex-clustered acoustic LOD when the engine config's
# `mesh_simplification` is True.
MESH_SIMPLIFICATION_TARGET_FACES = 4096

# Video (Scene's video settings; the scene video is 640 x 320 frames)
VIDEO_RESOLUTION = (1920, 960)  # width, height
VIDEO_FPS = 10
VIDEO_OVERLAY_DISTANCE_SCALE_FACTOR = 1.0
VIDEO_OVERLAY_BASE_SIZE = 0.5

# Scene-API entries (scripts/generate counterparts)
SCENE_DURATION = 60
DEFAULT_STATIC_EVENTS = 4
DEFAULT_MOVING_EVENTS = 1
MIC_ARRAY_TYPE = "ambeovr"
N_SCENES = 1000

# Acoustic imaging (APGD)
AIMG_FMIN, AIMG_FMAX = 1500, 4500
AIMG_NBANDS = 9
AIMG_SCALE = "linear"
AIMG_BANDWIDTH = 50.0
AIMG_TSTI = 10e-3
AIMG_FRAME_CAP = None
AIMG_SH_ORDER = 10
AIMG_CIRCLE_RADIUS_DEG = 20
AIMG_POLYGON_MASK_THRESHOLD = 4e-5
AIMG_RESOLUTION = 360, 180
AIMG_N_JOBS = -1
AIMG_VERBOSITY = 50
# Amplitude distribution of the real STARSS23 training data, which
# standardises synthetic amplitudes; must not change
AIMG_STARSS23_MU, AIMG_STARSS23_SIGMA = 0.0006131814582534336, 0.00048684798377322537
