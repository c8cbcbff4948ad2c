"""Can two ranks share one card?  Each backend (NCCL, gloo) is tried with
two processes on CUDA device 0 running the collectives the sharded train
step and ``quantized_psum`` use, on CUDA tensors: all-reduce (sum and
max), all-gather and reduce-scatter into one tensor, an int8
all-to-all and a barrier, each result checked against its expected
value.  Each process meets the other in a ``FileStore`` under
``build/``, with a 30 s group timeout, and the two are killed past a
deadline, so a backend that refuses or hangs is reported and does not
wait.

  python scripts/probe_ranks.py --out build/probe_ranks.json

Prints one line a backend and writes every rank's results as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

DEADLINE_S = 120.0


def _worker(backend: str, rank: int, world: int, store: str) -> dict:
    import datetime

    import torch
    import torch.distributed as dist
    out = {"rank": rank, "backend": backend}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=30))
    except Exception as e:  # noqa: BLE001 — the probe reports it
        out["init"] = repr(e)[:300]
        return out
    out["init"] = "ok"
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank

    def all_reduce_sum():
        t = x.clone()
        dist.all_reduce(t)
        return torch.equal(t, sum(torch.arange(8, dtype=torch.float32,
                                               device=dev) + r
                                  for r in range(world)))

    def all_reduce_max():
        t = x.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return torch.equal(t, x - rank + world - 1)

    def all_gather():
        t = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(t, x)
        return torch.equal(t.view(world, 8)[rank], x)

    def reduce_scatter():
        t = torch.empty(8 // world, device=dev)
        dist.reduce_scatter_tensor(t, x)
        want = sum(torch.arange(8, dtype=torch.float32, device=dev) + r
                   for r in range(world)).view(world, -1)[rank]
        return torch.equal(t, want)

    def all_to_all_int8():
        q = (x.to(torch.int8) + 10 * rank)
        t = torch.empty_like(q)
        dist.all_to_all_single(t, q)
        return t.dtype == torch.int8

    def barrier():
        dist.barrier()
        return True

    for name, fn in (("all_reduce_sum", all_reduce_sum),
                     ("all_reduce_max", all_reduce_max),
                     ("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("all_to_all_single_int8", all_to_all_int8),
                     ("barrier", barrier)):
        try:
            ok = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "wrong values"
        except Exception as e:  # noqa: BLE001 — the probe reports it
            out[name] = repr(e)[:300]
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass
    return out


def probe(backend: str, root: Path) -> dict:
    """Run two ranks of ``backend`` on device 0; their results, or what
    stopped them."""
    root.mkdir(parents=True, exist_ok=True)
    store = tempfile.mktemp(prefix=f"store_{backend}_", dir=root)
    outs = [root / f"{backend}_{r}.json" for r in range(2)]
    for o in outs:
        o.unlink(missing_ok=True)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         "--backend", backend, "--rank", str(r), "--store", store,
         "--out", str(outs[r])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs, killed = [], False
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(1.0, DEADLINE_S - (time.time() - t0)))[0])
        except subprocess.TimeoutExpired:
            killed = True
            p.kill()
            logs.append(p.communicate()[0])
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    ranks = [json.loads(o.read_text()) if o.exists() else None
             for o in outs]
    ops = [k for r in ranks if r for k in r if k not in ("rank", "backend")]
    works = all(r is not None for r in ranks) and all(
        r.get(k) == "ok" for r in ranks for k in ops)
    return {"backend": backend, "works": works, "killed": killed,
            "seconds": time.time() - t0, "ranks": ranks,
            "returncodes": [p.returncode for p in procs],
            "log_tails": [lg[-1500:] for lg in logs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", default=None)
    a = ap.parse_args(argv)
    if a.worker:
        Path(a.out).write_text(json.dumps(
            _worker(a.backend, a.rank, 2, a.store)))
        return 0
    import torch
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "nccl": ".".join(map(str, torch.cuda.nccl.version()))
              if torch.cuda.is_available() else None,
              "device": torch.cuda.get_device_name(0)
              if torch.cuda.is_available() else None, "probes": []}
    if not torch.cuda.is_available():
        print("probe_ranks: no CUDA device")
        return 2
    root = Path(__file__).resolve().parents[1] / "build" / "probe_ranks"
    for backend in ("nccl", "gloo"):
        r = probe(backend, root)
        report["probes"].append(r)
        first = next((f"rank {x['rank']}: {k} -> {v}"
                      for x in r["ranks"] if x for k, v in x.items()
                      if k not in ("rank", "backend") and v != "ok"), "")
        print(f"{backend}: two ranks on device 0 "
              f"{'WORK' if r['works'] else 'FAIL'} in {r['seconds']:.1f} s"
              f"{' (killed at the deadline)' if r['killed'] else ''}"
              f"{'; ' + first if first else ''}; return codes "
              f"{r['returncodes']}")
    print(json.dumps({k: report[k] for k in ("torch", "cuda", "nccl",
                                             "device")}))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
