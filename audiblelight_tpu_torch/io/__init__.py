"""Host I/O: audio files, meshes, SOFA RIRs and video (counterpart of
audiblelight_tpu/io/). Arrays reach the device path as numpy."""

from audiblelight_tpu_torch.io.audio import get_duration, load_audio, valid_audio, wav_read, wav_write

__all__ = [
    "wav_read",
    "wav_write",
    "get_duration",
    "load_audio",
    "valid_audio",
]
