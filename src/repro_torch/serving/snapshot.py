"""Crash-safe serving-engine snapshot and restore (the port's copy of
``repro/serving/snapshot.py``).

A snapshot holds everything a mid-trace engine needs to resume serving
where it stopped: KV storage (the page arena, or the dense slot states),
the scheduler's queue and slot map, every live request's prompt and
progress, the KV pool's ownership state (free-list order included, so
that later allocations replay identically), the prefix-cache trie,
metrics and the sampling state.  It goes through the port's
:class:`repro_torch.checkpoint.CheckpointManager` (the reference's format,
``step_<n>/{manifest.json, data.npz}``, atomic temp-dir + rename; bf16
leaves bit for bit), so a crash mid-save never corrupts the latest one.

The leaves sit under the reference's keys, so a snapshot either package
writes restores in the port: ``last_tok``, ``arena/k`` and ``arena/v``
(paged), ``state/cross_k`` and ``state/cross_v`` (an encdec engine's
dense cross K/V under the paged layout), ``kv_rows``, ``cache/pos``,
``cache/layers/<field>``, ``cache/attn/<field>`` (a hybrid's shared
attention K/V) and ``cache/cross_k`` / ``cache/cross_v`` (dense: the
reference's slot-major layout ``(S, L, 1, ...)``, a KV length ``(S,
L)``, which the port's ``(L, S, ...)`` cache is moved to on save and from
on restore), ``req/<i>/prompt``, ``req/<i>/generated`` and
``req/<i>/extras/<name>`` (vlm / encdec inputs), and the manifest's
metadata.  The reference's ``rng_key`` (a JAX PRNG key) means nothing to
the port: the port saves its ``torch.Generator`` state as ``rng_state``
beside it, and a restore without one (a snapshot the JAX engine wrote)
keeps the generator the seed gave, so only greedy tokens can match.

Restore targets a FRESH engine built with the same ``ArchConfig`` and
``EngineConfig`` (checked against the manifest): arrays are copied into
the engine's own tensors, request objects and pool tables are rebuilt,
and the request spans are re-opened in the tracker so that
close-exactly-once holds across the restart.  Under greedy decoding a
restored engine emits, for every surviving request, the tokens of the
uninterrupted run.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, _to_tensor
from repro_torch.serving.kv_pool import BlockTable
from repro_torch.serving.scheduler import Request

# EngineConfig fields that must match between snapshot and restore:
# anything that changes array shapes, allocation behaviour or the token
# stream itself
_SANITY = ("num_slots", "max_len", "block_size", "reserve", "temperature",
           "top_k", "seed", "prefill_chunk", "prefix_cache", "src_len")

_METRIC_SCALARS = (
    "decode_steps", "decode_tokens", "decode_s", "prefill_tokens",
    "prefill_s", "completed", "stalls", "preemptions", "failed", "expired",
    "shed", "cancelled", "rejected", "completed_in_deadline",
    "prefix_cache_fallbacks", "kv_read_tokens", "kv_read_tokens_dense",
    "prefill_kv_write_rows", "prefill_kv_write_rows_padded",
    "cache_hit_tokens", "cache_hit_pages", "prefill_flops_saved")
_METRIC_LISTS = ("ttft", "latency", "queue_delay", "slot_occupancy")

_POOL_COUNTERS = ("peak_in_use", "defrag_moves", "shared_pages",
                  "cow_copies", "poison_fills", "generation_faults",
                  "sanitize_checks")


def _sanity(engine) -> Dict:
    """The ``_SANITY`` values of an engine, with the resolved prefill chunk
    (the port's "auto" is what it resolves to)."""
    out = {k: getattr(engine.ecfg, k) for k in _SANITY}
    out["prefill_chunk"] = engine.prefill_chunk
    return out


def _req_meta(req: Request) -> Dict:
    return {
        "rid": req.rid,
        "max_new_tokens": int(req.max_new_tokens),
        "arrival_time": float(req.arrival_time),
        "eos_id": None if req.eos_id is None else int(req.eos_id),
        "deadline_s": (None if req.deadline_s is None
                       else float(req.deadline_s)),
        "slot": int(req.slot),
        "stalled": bool(req.stalled),
        "prefilling": bool(req.prefilling),
        "prefill_pos": int(req.prefill_pos),
        "cached_prefix_tokens": int(req.cached_prefix_tokens),
        "cached_pages": int(req.cached_pages),
        "preempt_count": int(req.preempt_count),
        "t_admit": float(req.t_admit),
        "t_first_token": float(req.t_first_token),
    }


def _slot_major(t: torch.Tensor) -> torch.Tensor:
    """A port leaf (L, S, ...) in the reference's slot-major layout: (S,
    L, 1, ...), or (S, L) for a KV length (a slot's batch-1 cache has a
    batch axis on every leaf but its lengths)."""
    t = t.transpose(0, 1)
    return t.unsqueeze(2) if t.dim() > 2 else t


def _dense_leaves(cache) -> Dict[str, torch.Tensor]:
    """{snapshot key: port leaf} of a dense cache, ``pos`` aside: a named
    tuple (``layers``, a hybrid's ``attn``) field by field."""
    out = {}
    for k, v in cache.items():
        if k == "pos":
            continue
        if isinstance(v, tuple):
            out.update({f"cache/{k}/{f}": t for f, t in zip(v._fields, v)})
        else:
            out[f"cache/{k}"] = v
    return out


def _dense_to_ref(cache) -> Dict:
    """The port's dense cache ``{"pos": (S,), "layers": (L, S, ...)[,
    "attn" | "cross_k", "cross_v"]}`` in the reference's slot-major
    layout: ``{"pos": (S,) int32, "layers": {field: (S, L, 1, ...)},
    ...}``."""
    out = {"pos": cache["pos"].to(torch.int32)}
    for k, v in cache.items():
        if k == "pos":
            continue
        out[k] = ({f: _slot_major(t) for f, t in zip(v._fields, v)}
                  if isinstance(v, tuple) else _slot_major(v))
    return out


def _dense_from_ref(engine, flat: Dict[str, np.ndarray]) -> None:
    """Copy the reference-layout dense leaves in ``flat`` into the
    engine's cache, in place."""
    c = engine._cache
    # saralint: ok[cow-gate] dense slot caches, not arena pages: nothing is shared
    _copy(c["pos"], flat, "cache/pos")
    for key, t in _dense_leaves(c).items():
        if key not in flat:
            raise KeyError(f"snapshot missing array {key!r}")
        a = _to_tensor(flat[key], t.dtype, t.device)
        want = tuple(_slot_major(t).shape)
        if tuple(a.shape) != want:
            raise ValueError(f"snapshot {key} has shape {tuple(a.shape)}, "
                             f"the engine's cache wants {want}")
        t.copy_((a[:, :, 0] if a.dim() > 2 else a).transpose(0, 1))


def _copy(dst: torch.Tensor, flat: Dict[str, np.ndarray], key: str) -> None:
    if key not in flat:
        raise KeyError(f"snapshot missing array {key!r}")
    a = _to_tensor(flat[key], dst.dtype, dst.device)
    if a.shape != dst.shape:
        raise ValueError(f"snapshot {key} has shape {tuple(a.shape)}, the "
                         f"engine's wants {tuple(dst.shape)}")
    dst.copy_(a)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_engine(engine, directory: str, blocking: bool = True) -> int:
    """Write one restorable snapshot of ``engine`` under ``directory``
    (numbered by the engine's step index).  Returns that step."""
    sched, pool = engine.sched, engine.pool
    live: List[Request] = (list(sched.waiting)
                           + [sched.active[s] for s in sorted(sched.active)])

    def host(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a))

    tree: Dict = {"last_tok": host(engine._last_tok),
                  "rng_state": engine._gen.get_state()}
    if engine.kv_layout == "paged":
        tree["arena"] = engine.arena.leaves
        if engine._state:
            tree["state"] = engine._state
        tree["kv_rows"] = host(engine._kv_rows)
    else:
        tree["cache"] = _dense_to_ref(engine._cache)
    reqs: Dict[str, Dict] = {}
    for i, r in enumerate(live):
        reqs[str(i)] = {"prompt": host(np.asarray(r.prompt, np.int32)),
                        "generated": host(np.asarray(r.generated,
                                                     np.int32))}
        if r.extras:
            reqs[str(i)]["extras"] = {k: host(np.asarray(v))
                                      for k, v in r.extras.items()}
    if reqs:
        tree["req"] = reqs

    m = engine.metrics
    metrics = {k: getattr(m, k) for k in _METRIC_SCALARS}
    metrics.update({k: list(getattr(m, k)) for k in _METRIC_LISTS})
    metrics["windows"] = {"ttft": list(m._ttft_win),
                          "latency": list(m._latency_win),
                          "decode": [list(x) for x in m._decode_win]}
    meta = {
        "arch": engine.cfg.name,
        "kv_layout": engine.kv_layout,
        "engine": _sanity(engine),
        "vtime": float(engine._vtime),
        "step_idx": int(engine._step_idx),
        "waiting": [r.rid for r in sched.waiting],
        "active": {str(s): sched.active[s].rid for s in sched.active},
        "free_slots": [int(s) for s in sched._free_slots],
        "requests": [_req_meta(r) for r in live],
        "pool": {
            "free": [int(b) for b in pool._free],
            "refs": list(pool._refs),
            "pins": list(pool._pins),
            "gen": list(pool._gen),
            "tables": {rid: {"blocks": list(t.blocks),
                             "num_tokens": int(t.num_tokens)}
                       for rid, t in pool._tables.items()},
            "counters": {k: getattr(pool, k) for k in _POOL_COUNTERS},
        },
        "metrics": metrics,
    }
    if engine.prefix_cache is not None:
        meta["prefix_cache"] = engine.prefix_cache.export_state()

    step = int(engine._step_idx)
    CheckpointManager(directory).save(step, tree, metadata=meta,
                                      blocking=blocking)
    return step


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def restore_engine(engine, directory: str,
                   step: Optional[int] = None) -> int:
    """Load a snapshot into a freshly constructed engine (same configs,
    nothing submitted yet).  Returns the restored step index."""
    if engine.requests or not engine.sched.idle():
        raise ValueError("restore needs a fresh engine: requests were "
                         "already submitted to this one")
    step, flat, meta = CheckpointManager(directory).restore_flat(step)

    if meta["arch"] != engine.cfg.name:
        raise ValueError(f"snapshot is for arch {meta['arch']!r}, engine "
                         f"runs {engine.cfg.name!r}")
    if meta["kv_layout"] != engine.kv_layout:
        raise ValueError(f"snapshot kv_layout {meta['kv_layout']!r} != "
                         f"engine {engine.kv_layout!r}")
    have = _sanity(engine)
    for k in _SANITY:
        if meta["engine"][k] != have[k]:
            raise ValueError(f"snapshot EngineConfig.{k}="
                             f"{meta['engine'][k]!r} != engine {have[k]!r}")

    # -- arrays ------------------------------------------------------------
    engine._last_tok = np.asarray(flat["last_tok"], np.int32).copy()
    if "rng_state" in flat:
        engine._gen.set_state(torch.from_numpy(
            np.asarray(flat["rng_state"], np.uint8).copy()))
    if engine.kv_layout == "paged":
        for name, leaf in engine.arena.leaves.items():
            # saralint: ok[cow-gate] restore fills a fresh engine (refused once a request was submitted) before any page has a reader
            _copy(leaf, flat, f"arena/{name}")
        for name, leaf in engine._state.items():
            _copy(leaf, flat, f"state/{name}")
        engine._kv_rows = np.asarray(flat["kv_rows"], np.int32).copy()
    else:
        _dense_from_ref(engine, flat)

    # -- pool --------------------------------------------------------------
    pool, pm = engine.pool, meta["pool"]
    pool._free = deque(int(b) for b in pm["free"])
    pool._refs = [int(x) for x in pm["refs"]]
    pool._pins = [int(x) for x in pm["pins"]]
    pool._gen = [int(x) for x in pm["gen"]]
    pool._tables = {
        rid: BlockTable(rid, blocks=[int(b) for b in t["blocks"]],
                        num_tokens=int(t["num_tokens"]))
        for rid, t in pm["tables"].items()}
    for k, v in pm["counters"].items():
        setattr(pool, k, v)

    # -- requests + scheduler ---------------------------------------------
    by_rid: Dict[str, Request] = {}
    for i, m in enumerate(meta["requests"]):
        extras_keys = [k for k in flat if k.startswith(f"req/{i}/extras/")]
        extras = ({k.rsplit("/", 1)[1]: flat[k] for k in extras_keys}
                  or None)
        req = Request(rid=m["rid"],
                      prompt=np.asarray(flat[f"req/{i}/prompt"], np.int32),
                      max_new_tokens=m["max_new_tokens"],
                      arrival_time=m["arrival_time"], eos_id=m["eos_id"],
                      extras=extras, deadline_s=m["deadline_s"])
        req.generated = [int(x) for x in flat[f"req/{i}/generated"]]
        req.slot = m["slot"]
        req.stalled = m["stalled"]
        req.prefilling = m["prefilling"]
        req.prefill_pos = m["prefill_pos"]
        req.cached_prefix_tokens = m["cached_prefix_tokens"]
        req.cached_pages = m["cached_pages"]
        req.preempt_count = m["preempt_count"]
        req.t_admit = m["t_admit"]
        req.t_first_token = m["t_first_token"]
        by_rid[req.rid] = req
    sched = engine.sched
    sched.waiting = deque(by_rid[rid] for rid in meta["waiting"])
    sched.active = {int(s): by_rid[rid]
                    for s, rid in meta["active"].items()}
    sched._free_slots = [int(s) for s in meta["free_slots"]]
    engine.requests = dict(by_rid)
    # re-open lifecycle spans so close-exactly-once holds across restarts
    for rid in meta["waiting"]:
        r = by_rid[rid]
        engine.req_spans.on_submit(rid, prompt_len=r.prompt_len,
                                   max_new=r.max_new_tokens)
    for s, rid in sorted(meta["active"].items()):
        r = by_rid[rid]
        engine.req_spans.on_submit(rid, prompt_len=r.prompt_len,
                                   max_new=r.max_new_tokens)
        engine.req_spans.on_admit(rid, slot=r.slot)

    # -- prefix cache ------------------------------------------------------
    if engine.prefix_cache is not None and "prefix_cache" in meta:
        engine.prefix_cache.restore_state(meta["prefix_cache"])

    # -- metrics -----------------------------------------------------------
    mm = meta["metrics"]
    for k in _METRIC_SCALARS:
        setattr(engine.metrics, k, mm[k])
    for k in _METRIC_LISTS:
        setattr(engine.metrics, k, list(mm[k]))
    engine.metrics._ttft_win.extend(mm["windows"]["ttft"])
    engine.metrics._latency_win.extend(mm["windows"]["latency"])
    engine.metrics._decode_win.extend(
        tuple(x) for x in mm["windows"]["decode"])

    engine._vtime = float(meta["vtime"])
    engine._step_idx = int(meta["step_idx"])
    return step
