"""Checkpoints in the reference's format, read and written.

``repro/checkpoint/manager.py`` writes one directory per step,
``step_<8 digits>/{manifest.json, data.npz}``, with every leaf under its
``/``-joined tree path (``layers/attn/wq`` is the (L, d, q_dim) stack of
every layer's query weight; a named tuple's fields by name, so a training
state saves as ``params/...``, ``opt/step``, ``opt/m/...``, ``opt/v/...``).
:func:`load_checkpoint` reads that layout with numpy alone, and
:func:`params_from_numpy` turns the flat leaves into the port's parameter
dict for a config, so both packages can run on the same weights.
:class:`CheckpointManager` writes it (atomic rename, ``keep`` newest
steps, optional save on a writer thread) and restores into a tree of
tensors, so each package restores what the other saved.

On a mesh the files are the same: a save gathers every leaf to full and
rank 0 writes it (:func:`save_sharded`), and :func:`restore_resharded`
reads the file on every rank and keeps the rank's block of each leaf
under the specs of the mesh it restores onto, which need not be the one
that saved.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.modules import dtype_of
from repro_torch.models.moe import padded_num_experts
from repro_torch.models.ssm import mamba_dims, rwkv_num_heads
from repro_torch.models.transformer import (_is_moe_layer, hybrid_layout,
                                            num_dense_layers)


def _steps(directory: Path):
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if (p / "manifest.json").exists())


def load_checkpoint(directory, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, np.ndarray], dict]:
    """(step, {path: array}, metadata) of the latest (or given) step.
    Leaves the manifest records as bfloat16 (which numpy stores as raw
    2-byte records) come back as uint16 bit patterns; the manifest's
    dtypes say which, and :func:`params_from_numpy` reinterprets them."""
    d = Path(directory)
    steps = _steps(d)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {d}")
        step = steps[-1]
    sd = d / f"step_{step:08d}"
    manifest = json.loads((sd / "manifest.json").read_text())
    flat = {}
    with np.load(sd / "data.npz") as data:
        for k in data.files:
            a = data[k]
            if manifest["dtypes"].get(k) == "bfloat16":
                a = a.view(np.uint16)
            flat[k] = a
    return step, flat, manifest.get("metadata", {})


def _gqa_shapes(a: str, n: int, cfg: ArchConfig) -> Dict[str, tuple]:
    """Leaves of n stacked GQA blocks under ``a``, biases included."""
    d = cfg.d_model
    shapes = {f"{a}/wq": (n, d, cfg.q_dim), f"{a}/wk": (n, d, cfg.kv_dim),
              f"{a}/wv": (n, d, cfg.kv_dim), f"{a}/wo": (n, cfg.q_dim, d)}
    if cfg.use_bias:
        shapes.update({f"{a}/bq": (n, cfg.q_dim), f"{a}/bk": (n, cfg.kv_dim),
                       f"{a}/bv": (n, cfg.kv_dim)})
    return shapes


def _mlp_shapes(m: str, n: int, cfg: ArchConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    return {f"{m}/w_gate": (n, d, cfg.d_ff), f"{m}/w_up": (n, d, cfg.d_ff),
            f"{m}/w_down": (n, cfg.d_ff, d)}


def _stack_shapes(prefix: str, n: int, cfg: ArchConfig, moe: bool,
                  cross: bool = False) -> Dict[str, tuple]:
    """Leaves of a stack of n decoder layers under ``prefix`` (with
    ``cross``, an encdec decoder's cross-attention block and its norm)."""
    d, H = cfg.d_model, cfg.num_heads
    shapes = {f"{prefix}/ln1": (n, d), f"{prefix}/ln2": (n, d)}
    if cross:
        shapes[f"{prefix}/ln_cross"] = (n, d)
        shapes.update(_gqa_shapes(f"{prefix}/cross", n, cfg))
    a = f"{prefix}/attn"
    if cfg.attention_type == "mla":
        m = cfg.mla
        shapes.update({
            f"{a}/w_dq": (n, d, m.q_lora_rank),
            f"{a}/q_norm": (n, m.q_lora_rank),
            f"{a}/w_uq": (n, m.q_lora_rank,
                          H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            f"{a}/w_dkv": (n, d, m.kv_lora_rank + m.qk_rope_head_dim),
            f"{a}/kv_norm": (n, m.kv_lora_rank),
            f"{a}/w_uk": (n, m.kv_lora_rank, H * m.qk_nope_head_dim),
            f"{a}/w_uv": (n, m.kv_lora_rank, H * m.v_head_dim),
            f"{a}/wo": (n, H * m.v_head_dim, d)})
    else:
        shapes.update(_gqa_shapes(a, n, cfg))
    if moe:
        mo = cfg.moe
        E, f = padded_num_experts(cfg), mo.d_ff_expert
        fs = f * mo.num_shared_experts
        shapes.update({f"{prefix}/moe/router": (n, d, E),
                       f"{prefix}/moe/w_gate": (n, E, d, f),
                       f"{prefix}/moe/w_up": (n, E, d, f),
                       f"{prefix}/moe/w_down": (n, E, f, d)})
        if fs:
            shapes.update({f"{prefix}/moe/shared/w_gate": (n, d, fs),
                           f"{prefix}/moe/shared/w_up": (n, d, fs),
                           f"{prefix}/moe/shared/w_down": (n, fs, d)})
    else:
        shapes.update(_mlp_shapes(f"{prefix}/mlp", n, cfg))
    return shapes


def _rwkv_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """Leaves of the stacked RWKV6 layers: ``ln1`` and every leaf of the
    reference's ``init_rwkv_block``."""
    L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff
    H, K = rwkv_num_heads(cfg), cfg.ssm.head_dim
    lora = max(32, d // 32)
    blk = {**{m: (d,) for m in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                                "mu_ck", "mu_cr", "decay_base")},
           **{w: (d, d) for w in ("w_r", "w_k", "w_v", "w_g", "w_o",
                                  "w_cr")},
           **{n: (H, K) for n in ("bonus_u", "ln_scale", "ln_bias")},
           "w_decay_a": (d, lora), "w_decay_b": (lora, d),
           "w_ck": (d, ff), "w_cv": (ff, d)}
    shapes = {f"layers/blk/{k}": (L,) + v for k, v in blk.items()}
    shapes["layers/ln1"] = (L, d)
    return shapes


def _hybrid_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """Leaves of a hybrid model: ``ln1`` and every leaf of the reference's
    ``init_mamba_block`` stacked over the Mamba layers, and the one shared
    attention + MLP block, unstacked."""
    d = cfg.d_model
    n_m = hybrid_layout(cfg)[0]
    d_inner, H, _, N = mamba_dims(cfg)
    conv_ch = d_inner + 2 * N
    blk = {"w_in": (d, 2 * d_inner + 2 * N + H),
           "conv_w": (cfg.ssm.conv_width, conv_ch), "conv_b": (conv_ch,),
           "A_log": (H,), "dt_bias": (H,), "D": (H,),
           "norm_scale": (d_inner,), "w_out": (d_inner, d)}
    shapes = {f"layers/blk/{k}": (n_m,) + v for k, v in blk.items()}
    shapes["layers/ln1"] = (n_m, d)
    shared = _stack_shapes("shared_attn", 1, cfg, moe=False)
    shapes.update({k: v[1:] for k, v in shared.items()})
    return shapes


def _expected_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    L, d = cfg.num_layers, cfg.d_model
    nd = num_dense_layers(cfg)
    shapes = {"embed": (cfg.vocab_size, d), "ln_f": (d,)}
    fe = cfg.frontend
    if fe.kind == "audio_frames":
        shapes["frontend/proj"] = (fe.feature_dim, d)
    elif fe.kind == "vision_patches":
        shapes.update({"frontend/proj1": (fe.feature_dim, d),
                       "frontend/proj2": (d, d)})
    if cfg.family == "ssm":
        shapes.update(_rwkv_shapes(cfg))
    elif cfg.family == "hybrid":
        shapes.update(_hybrid_shapes(cfg))
    elif cfg.family == "encdec":
        n = cfg.encoder_layers
        shapes.update({"enc_layers/ln1": (n, d), "enc_layers/ln2": (n, d),
                       "ln_enc": (d,)})
        shapes.update(_gqa_shapes("enc_layers/attn", n, cfg))
        shapes.update(_mlp_shapes("enc_layers/mlp", n, cfg))
        shapes.update(_stack_shapes("layers", L, cfg, moe=False,
                                    cross=True))
    else:
        if nd:
            shapes.update(_stack_shapes("dense_layers", nd, cfg, moe=False))
        shapes.update(_stack_shapes("layers", L - nd, cfg,
                                    moe=_is_moe_layer(cfg, nd)))
    if not cfg.tie_embeddings:
        shapes["unembed"] = (d, cfg.vocab_size)
    return shapes


# leaves the reference draws in f32 whatever ``param_dtype`` is (its
# init_moe gives the router and the shared expert's w_down no dtype)
F32_LEAVES = ("moe/router", "moe/shared/w_down")


def _leaf_dtype(key: str, cfg: ArchConfig) -> torch.dtype:
    if key.endswith(F32_LEAVES):
        return torch.float32
    return dtype_of(cfg.param_dtype)


def _to_tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if a.dtype == np.uint16 or a.dtype.kind == "V" or \
            a.dtype.name == "bfloat16":
        # bfloat16 bit patterns (raw or ml_dtypes): reinterpret, no rounding
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ArchConfig,
                      device) -> Dict:
    """The port's parameter dict from the reference's flat leaves for a
    served ``cfg`` (any arch of the registry), in ``cfg.param_dtype``
    (``F32_LEAVES`` in f32, as the reference draws them) on ``device``.
    Raises on a missing, unexpected or misshapen leaf."""
    want = _expected_shapes(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint leaves do not match {cfg.name}: "
                       f"missing {missing}, unexpected {extra}")
    params: Dict = {}
    for key, shape in want.items():
        a = flat[key]
        if tuple(a.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(a.shape)} != {shape}")
        node = params
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = _to_tensor(a, _leaf_dtype(key, cfg), device)
    return params


# ---------------------------------------------------------------------------
# the manager: save and restore trees of tensors
# ---------------------------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that nothing else aliases (the caller may update
    ``t`` in place while a writer thread saves the copy).  bfloat16 leaves
    become raw 2-byte records, as numpy saves the reference's."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _flatten(tree, prefix: str = "") -> Dict[str, Tuple[np.ndarray, str]]:
    """{path: (host array, dtype name)} over nested dicts and named
    tuples, keyed as the reference's ``_flatten`` keys them."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        name = str(tree.dtype).replace("torch.", "")
        return {prefix[:-1]: (_host(tree), name)}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def _unflatten(target, flat: Dict[str, np.ndarray], prefix: str = ""):
    """``target``'s structure with each leaf read from ``flat`` in the
    leaf's dtype on the leaf's device."""
    if isinstance(target, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_unflatten(v, flat, f"{prefix}{k}/")
                              for k, v in zip(target._fields, target)))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing {key}")
    return _to_tensor(flat[key], target.dtype, target.device)


class CheckpointManager:
    """The reference's ``CheckpointManager`` on trees of tensors."""

    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def steps(self):
        return _steps(self.dir)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             blocking: bool = True) -> None:
        # every leaf is copied to the host here, on the calling thread
        flat = _flatten(tree)

        def _write():
            with self._lock:
                tmp = self.dir / f".tmp_step_{step:08d}_{os.getpid()}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "data.npz", **{k: a for k, (a, _) in
                                              flat.items()})
                manifest = {
                    "step": step,
                    "time": time.time(),
                    "keys": sorted(flat),
                    "shapes": {k: list(a.shape) for k, (a, _) in
                               flat.items()},
                    "dtypes": {k: d for k, (_, d) in flat.items()},
                    "metadata": metadata or {},
                }
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                final = self._step_dir(step)
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()

        if blocking:
            _write()
        else:
            self.wait()
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore_flat(self, step: Optional[int] = None
                     ) -> Tuple[int, Dict[str, np.ndarray], dict]:
        return load_checkpoint(self.dir, step)

    def restore(self, target_tree: Any, step: Optional[int] = None
                ) -> Tuple[int, Any, dict]:
        """Restore into the structure, dtypes and devices of
        ``target_tree``."""
        step, flat, meta = self.restore_flat(step)
        return step, _unflatten(target_tree, flat), meta


def save_sharded(mgr: CheckpointManager, step: int, tree: Any, specs: Any,
                 mesh, metadata: Optional[dict] = None,
                 blocking: bool = True) -> None:
    """Save a tree held as blocks under ``specs``: every rank gathers
    every leaf (a collective), rank 0 writes the unchanged format, and
    all ranks meet at a barrier.  With ``blocking=False`` rank 0 writes
    on its writer thread, and a reader first waits for it (``mgr.wait()``
    on rank 0, then a barrier)."""
    import torch.distributed as dist

    from repro_torch.parallel.sharding import gather_tree
    full = gather_tree(tree, specs, mesh)
    if dist.get_rank() == 0:
        mgr.save(step, full, metadata=metadata, blocking=blocking)
    del full
    dist.barrier()


def restore_resharded(directory, target_tree: Any, mesh, specs,
                      step: Optional[int] = None) -> Tuple[int, Any, dict]:
    """Elastic restore: the latest (or given) checkpoint onto ``mesh``.
    Every rank reads the file and keeps its block of each leaf under
    ``specs``, in the dtype and on the device of ``target_tree``'s leaf
    (local blocks or full leaves: only the structure, dtypes and devices
    are read)."""
    from repro_torch.parallel.sharding import shard_tree
    step, flat, meta = load_checkpoint(directory, step)
    return step, shard_tree(_unflatten(target_tree, flat), specs, mesh), meta
