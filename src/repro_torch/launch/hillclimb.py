"""Hill-climb launcher: run a named VARIANT (a set of config overrides) of
one (arch x shape) cell on the card, record its roofline terms next to
the baseline's, and print the change of every term — the port of
``repro/launch/hillclimb.py``.

Each iteration of the hypothesis -> change -> measure -> validate loop is
one invocation; results accumulate in ``build/hillclimb/<arch>__<shape>.json``
as an ordered log, one entry a variant (a variant already in the log is
not run again unless ``--force`` is given).  Where the reference reads a
variant's terms from its compiled HLO, the port measures them
(``launch/profile.py::profile_cell``): the step's wall and its kernels'
device time; ``per_device_hbm_bytes`` is the peak allocated memory.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch llama3.2-1b \\
      --shape prefill_32k --optimized --variant chunk256 \\
      --hypothesis "smaller blocks fill more SMs" --set attn_chunk=256
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch llama3.2-1b \\
      --shape train_4k --variant baseline --preset reduced --seq-len 64 \\
      --device cpu
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from repro_torch.launch.profile import (add_cell_args, parse_override,
                                        profile_cell, start)

TERMS = ("step_s", "busy_s", "profiled_s", "idle_share", "ideal_compute_s",
         "ideal_memory_s", "roofline_fraction", "bound_attainment")


def run_variant(arch: str, shape: str, variant: str, overrides: dict,
                hypothesis: str, out_dir: Path, force: bool = False,
                batch: int = 1, device: Optional[str] = None,
                optimized: bool = False, preset: str = "full",
                seq_len: Optional[int] = None, steps: int = 3) -> dict:
    out_path = Path(out_dir) / f"{arch}__{shape}.json"
    log = json.loads(out_path.read_text()) if out_path.exists() else []
    for e in log:
        if e["variant"] == variant and not force:
            print(f"[cached] {variant}")
            return e

    out = profile_cell(arch, shape, overrides, top=0, batch=batch,
                       device=device, optimized=optimized, steps=steps,
                       preset=preset, seq_len=seq_len)
    entry = {
        "variant": variant,
        "overrides": {k: repr(v) for k, v in overrides.items()},
        "hypothesis": hypothesis,
        "device": out["device"], "device_name": out["device_name"],
        "batch": out["batch"], "seq_len": out["seq_len"],
        "build_s": round(out["build_s"], 2),
        "per_device_hbm_bytes": out["peak_memory_bytes"],
        "roofline": out["terms"].to_dict(),
    }
    log = [e for e in log if e["variant"] != variant] + [entry]
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(log, indent=1))

    base = next((e for e in log if e["variant"] == "baseline"), None)
    _print_entry(entry, base)
    return entry


def _print_entry(e: dict, base: Optional[dict]) -> None:
    r = e["roofline"]
    print(f"\n== {e['variant']}  ({e['hypothesis']}) on {e['device_name']}")
    print(f"   overrides: {e['overrides']}")
    for t in TERMS:
        if r[t] is None:
            print(f"   {t:18} not measured")
            continue
        delta = ""
        if base and base is not e and base["roofline"][t]:
            b = base["roofline"][t]
            delta = f"  ({(r[t] - b) / b * 100:+.1f}% vs baseline)"
        print(f"   {t:18} {r[t]:12.6f}{delta}")
    hbm = e["per_device_hbm_bytes"]
    print(f"   dominant={r['dominant']}  hbm/dev="
          + ("not measured" if hbm is None else f"{hbm / 1e9:.2f}GB"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="build/hillclimb")
    add_cell_args(ap)
    args = ap.parse_args(argv)
    start(args)
    overrides = dict(parse_override(kv) for kv in args.set)
    run_variant(args.arch, args.shape, args.variant, overrides,
                args.hypothesis, Path(args.out), args.force, args.batch,
                args.device, args.optimized, args.preset, args.seq_len,
                args.steps)


if __name__ == "__main__":
    main()
