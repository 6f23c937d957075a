"""The output check's control: the plain reference put in the program's
place, computed in the precision below the configuration's (bfloat16 for
float32), read against the reference at the cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

prints, for each seed, every number the check compares (`check.numbers_of`:
the backend reference's, or the widest payload gap) between the control
and the reference on the traffic's first scene. A number's limit has to lie
below the smallest of its readings, for one number at least.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def readings(workload: str, seeds: list, root: Path, device: str = "cuda", config_overrides: dict = None,
             mix_overrides: dict = None) -> list:
    """[{"seed", each number}] of the control on each seed."""
    from portbench import check, manifest, traffic
    from portbench.reference import audio

    cell = manifest.cell(manifest.load_manifest(root), workload)
    config = dict(manifest.load_config(cell["config"]), **(config_overrides or {}))
    mix = dict(manifest.load_mix(cell["traffic"]), **(mix_overrides or {}))
    out = []
    for seed in seeds:
        specs = {0: traffic.scene(config, mix, seed, 0)}
        clips = traffic.clips(mix, int(config["sample_rate"]), seed)
        kept = [(dict(index=0), None)]
        exact = check.reference_payloads(config, specs, clips, kept, device)[0]
        low = check.reference_payloads(config, specs, clips, kept, device, lowp=audio.bfloat16)[0]
        out.append(dict(seed=seed, **check.numbers_of(config)(low, exact)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for r in readings(args.workload, args.seeds, Path.cwd()):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
