"""Time the ADAPTNETX kernel (``csrc/adaptnetx.cu``) under its plan and the
plans its rule turned down, on the card.

    PYTHONPATH=src python -m repro_torch.launch.bench_adaptnetx [--out FILE]

Cases: one query and a batch of 64 at 75, 108 and 135 classes (E = 16,
H = 128: the reference's tests' and the port's tile spaces; 135 is
``chip_smoke.py`` phase 9's path A), then the card tests' other widths
(E, H, C, table rows) = (8, 256, 300, 7), (64, 1024, 3, 1) and (1, 1, 1,
2) at one query and a batch of 33.  Each time is the median device time
of 15 runs through ``chip_smoke.py``'s ``Timer`` (L2 flushed before each
run, a spin kernel holding the card while the host queues the run),
beside the timer's floor (one launch adding 1 to one element), the time
net of that floor, the plain version's time and the bound
(``chip_smoke.py``'s: the weights, each query's ids, embedding rows and
logits moved once over 3.35 TB/s against its f32 operations over 67
TFLOP/s).  Under ``_adaptnetx_plan``'s plan and every forced variant
(``variants``) the logits are held to the plain version (the reference's
rtol = atol = 1e-5), to themselves run to run and to the plan's bitwise.
One line per variant; the records go to ``--out`` as JSON.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import adaptnetx as ax

ROOT = Path(__file__).resolve().parents[3]
HBM, PEAK_F32 = 3.35e12, 67e12
# name, E, H, C, table rows, B
CASES = ([(f"C={C} B={B}", 16, 128, C, 10_001, B)
          for C in (75, 108, 135) for B in (1, 64)]
         + [(f"E={E} H={H} C={C} B={B}", E, H, C, rows, B)
            for E, H, C, rows in ((8, 256, 300, 7), (64, 1024, 3, 1),
                                  (1, 1, 1, 2)) for B in (1, 33)])


def smoke_timer():
    """``chip_smoke.py``'s ``Timer``, loaded from the checkout's root."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Timer(torch)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def bound_ms(E, H, C, B):
    nbytes = 4 * (3 * E * H + H + H * C + C) + B * 4 * (3 * E + 3 + C)
    t_b = nbytes / HBM * 1e3
    t_o = B * 2.0 * (3 * E * H + H * C) / PEAK_F32 * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def variants(B, E, H, C):
    """{name: plan} of the plan and each forced alternative."""
    out = {"plan": ax._adaptnetx_plan(B, E, H, C)}
    for key, kw in ax.VARIANTS:
        try:
            plan = ax._adaptnetx_plan(B, E, H, C, **kw)
        except ValueError:          # a variant the shape cannot take
            continue
        if plan not in out.values():
            out[key] = plan
    return out


def params(gen, E, H, C, rows):
    def rn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")
    return [rn(rows, E) * 0.02, rn(rows, E) * 0.02, rn(rows, E) * 0.02,
            rn(3 * E, H) / (3 * E) ** 0.5, rn(H) * 0.1, rn(H, C) / H ** 0.5,
            rn(C) * 0.1]


def run_case(timer, name, E, H, C, rows, B, gen):
    p = params(gen, E, H, C, rows)
    if B == 1 and rows > 8910:
        ids = torch.tensor([[123, 4567, 8910]], dtype=torch.int32,
                           device="cuda")
    else:
        ids = torch.randint(-2, rows + 3, (B, 3), generator=gen,
                            device="cuda", dtype=torch.int32)
    want = ax.adaptnetx_plain(ids, *p)
    b_ms, b_by = bound_ms(E, H, C, B)
    rec = {"name": name, "E": E, "H": H, "C": C, "rows": rows, "B": B,
           "bound_ms": b_ms, "bound_by": b_by,
           "plain_ms": timer(lambda: ax.adaptnetx_plain(ids, *p)),
           "variants": {}}

    def kernel(plan):
        return ax.adaptnetx_cuda(ids, *p, plan=plan)
    vs = variants(B, E, H, C)
    ref = kernel(vs["plan"])
    for key, plan in vs.items():
        got, again = kernel(plan), kernel(plan)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rec["variants"][key] = {
            "plan": dict(plan._asdict(), combine=plan.combine),
            "ms": timer(lambda: kernel(plan)), "max_abs_err": err,
            "ok": bool(((got - want).abs()
                        <= 1e-5 + 1e-5 * want.abs()).all()),
            "run_to_run": torch.equal(got, again),
            "bitwise_plan": torch.equal(got, ref)}
    return rec


def plan_str(p) -> str:
    return (f"{p['tiles']} tiles of {p['qt']} queries x {p['ctiles']} of "
            f"{p['ct']} classes, {p['groups']} CTAs a tile x {p['chunks']} "
            f"chunks, {p['combine']}, {p['stages']} stages = {p['ctas']} "
            f"CTAs, {p['smem']} B smem")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/bench_adaptnetx.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_adaptnetx: needs a CUDA card")
        return 2
    print(card_line(), flush=True)
    timer = smoke_timer()
    one = torch.zeros(1, device="cuda")
    report = {"device": torch.cuda.get_device_name(0), "card": card_line(),
              "floor_ms": timer(lambda: one.add_(1.0)), "cases": []}
    floor = report["floor_ms"]
    print(f"timer floor (one launch adding 1 to one element): {floor:.4f} "
          f"ms", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    ok = True
    for case in CASES:
        rec = run_case(timer, *case, gen)
        report["cases"].append(rec)
        for key, v in rec["variants"].items():
            v["net_ms"] = v["ms"] - floor
            good = v["ok"] and v["run_to_run"] and v["bitwise_plan"]
            ok &= good
            print(f"{rec['name']:<24} {key:<14} {v['ms']:.4f} ms (net "
                  f"{v['net_ms']:.4f}), err {v['max_abs_err']:.2e} "
                  f"{'ok' if good else 'FAIL'}, run to run "
                  f"{v['run_to_run']}, plan bits {v['bitwise_plan']}  "
                  f"(plain {rec['plain_ms']:.4f}, bound "
                  f"{rec['bound_ms']:.6f} {rec['bound_by']}) "
                  f"[{plan_str(v['plan'])}]", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
