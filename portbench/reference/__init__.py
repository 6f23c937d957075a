"""The plain reference of the output check, written from the semantics
the configurations state and importing nothing of the program.

`audio.py` holds the stages every backend shares (dry audio, stems, level,
stem quantisation, mix, bed, WAV samples); each backend has a module of
its own named as the configuration's `backend` (`shoebox.py`), whose
`render(config, spec, clips, bed_seed, device, lowp)` gives a scene's
int16 payload from the benchmark's inputs alone.
"""
