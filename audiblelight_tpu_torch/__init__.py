"""PyTorch/CUDA port of audiblelight_tpu's fused scene render.

The device half of the SELD scene program: ray-trace the RIRs of a placed
scene in a scanned mesh room, gather them per event, render the stems, place
them in the timeline, add the ambience bed and quantise to an int16 WAV
payload. The first-hit, any-hit and deposit-histogram kernels are hand-written
CUDA for Hopper (`csrc/`), each beside a plain PyTorch version of the same
function (`ops/cuda_kernels.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; they never
fall back to the CPU on their own.
"""
