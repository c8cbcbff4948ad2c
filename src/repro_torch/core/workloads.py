"""Evaluation workloads (paper §V-A): FasterRCNN, DeepSpeech2, AlphaGoZero
layer GEMMs + the synthetic G1..G20 set (Table IV).

A copy of ``repro/core/workloads.py`` (numpy only), so that the port's
self-adaptive GEMM loop (``launch/selfadaptive_gemm.py``) runs the same
layers as the reference's example.

Conv layers are given as im2col GEMMs: M = out_h*out_w, N = filters,
K = kh*kw*c_in (batch 1, SCALE-Sim convention).  The layer lists are
reconstructed from the public network topologies (SCALE-Sim topology-file
style); the paper does not publish its exact CSVs, so dims are documented
approximations of the same networks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class Layer:
    name: str
    M: int
    K: int
    N: int


def _conv(name, oh, ow, kh, kw, cin, cout) -> Layer:
    return Layer(name, oh * ow, kh * kw * cin, cout)


# ---- AlphaGoZero: 19x19 board, 256-filter residual tower [36] -------------
def alphagozero() -> List[Layer]:
    layers = [_conv("conv_in", 19, 19, 3, 3, 17, 256)]
    for i in range(19):
        layers.append(_conv(f"res{i}", 19, 19, 3, 3, 256, 256))
    layers.append(_conv("policy", 19, 19, 1, 1, 256, 2))
    layers.append(_conv("value", 19, 19, 1, 1, 256, 1))
    return layers


# ---- DeepSpeech2: conv frontend + bidirectional GRU stack [2] -------------
def deepspeech2(T: int = 341) -> List[Layer]:
    # conv1 41x11x1 -> 32, conv2 21x11x32 -> 32 on (time x freq) = (341 x 40)
    layers = [
        _conv("conv1", T, 40, 41, 11, 1, 32),
        _conv("conv2", T, 20, 21, 11, 32, 32),
    ]
    d = 1312      # flattened conv features entering the RNN stack
    h = 1760      # DS2 hidden size
    for i in range(5):
        din = d if i == 0 else h
        # GRU as GEMMs: input proj (3h) + recurrent proj (3h)
        layers.append(Layer(f"gru{i}_x", T, din, 3 * h))
        layers.append(Layer(f"gru{i}_h", T, h, 3 * h))
    layers.append(Layer("fc", T, h, 29))
    return layers


# ---- FasterRCNN: VGG-16 backbone + RPN + heads [31] ------------------------
def fasterrcnn() -> List[Layer]:
    L: List[Layer] = []
    cfg = [  # (out_hw, cin, cout, repeat)
        (224, 3, 64, 1), (224, 64, 64, 1),
        (112, 64, 128, 1), (112, 128, 128, 1),
        (56, 128, 256, 1), (56, 256, 256, 2),
        (28, 256, 512, 1), (28, 512, 512, 2),
        (14, 512, 512, 3),
    ]
    i = 0
    for hw, cin, cout, rep in cfg:
        for _ in range(rep):
            i += 1
            L.append(_conv(f"conv{i}", hw, hw, 3, 3, cin, cout))
    L.append(_conv("rpn_conv", 14, 14, 3, 3, 512, 512))       # layer 14
    L.append(_conv("rpn_cls", 14, 14, 1, 1, 512, 18))
    L.append(_conv("rpn_box", 14, 14, 1, 1, 512, 36))
    L.append(Layer("fc6", 300, 25088, 4096))                  # 300 RoIs
    L.append(Layer("fc7", 300, 4096, 4096))                   # "layer 19"
    L.append(Layer("cls_score", 300, 4096, 21))
    L.append(Layer("bbox_pred", 300, 4096, 84))
    return L


# ---- sensitivity-analysis networks (Fig. 11f-g) ----------------------------
def resnet50() -> List[Layer]:
    L = [_conv("conv1", 112, 112, 7, 7, 3, 64)]
    spec = [(56, 64, 64, 256, 3), (28, 256, 128, 512, 4),
            (14, 512, 256, 1024, 6), (7, 1024, 512, 2048, 3)]
    i = 1
    for hw, cin, mid, cout, rep in spec:
        for r in range(rep):
            i += 1
            L.append(_conv(f"b{i}a", hw, hw, 1, 1, cin if r == 0 else cout, mid))
            L.append(_conv(f"b{i}b", hw, hw, 3, 3, mid, mid))
            L.append(_conv(f"b{i}c", hw, hw, 1, 1, mid, cout))
    L.append(Layer("fc", 1, 2048, 1000))
    return L


def bert_base(S: int = 512) -> List[Layer]:
    d, h, ff = 768, 12, 3072
    L = []
    for i in range(12):
        L.append(Layer(f"l{i}_qkv", S, d, 3 * d))
        L.append(Layer(f"l{i}_attn_qk", S, d // h, S))   # per-head scores
        L.append(Layer(f"l{i}_attn_v", S, S, d // h))
        L.append(Layer(f"l{i}_o", S, d, d))
        L.append(Layer(f"l{i}_ff1", S, d, ff))
        L.append(Layer(f"l{i}_ff2", S, ff, d))
    return L


# ---- synthetic GEMMs, Table IV ---------------------------------------------
def synthetic_g() -> List[Layer]:
    dims: List[Tuple[int, int, int]] = [
        (128, 128, 128), (256, 256, 256), (512, 512, 512),
        (1024, 1024, 1024), (2048, 2048, 2048),
        (128, 64, 64), (256, 64, 64), (512, 64, 64),
        (1024, 64, 64), (2048, 64, 64),
        (64, 64, 128), (64, 64, 256), (64, 64, 512),
        (64, 64, 1024), (64, 64, 2048),
        (64, 128, 64), (64, 256, 64), (64, 512, 64),
        (64, 1024, 64), (64, 2048, 64),
    ]
    return [Layer(f"G{i+1}", m, k, n) for i, (m, k, n) in enumerate(dims)]


WORKLOADS = {
    "alphagozero": alphagozero,
    "deepspeech2": deepspeech2,
    "fasterrcnn": fasterrcnn,
    "resnet50": resnet50,
    "bert_base": bert_base,
    "synthetic": synthetic_g,
}


def layer_dims(layers: List[Layer]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    M = np.array([l.M for l in layers])
    K = np.array([l.K for l in layers])
    N = np.array([l.N for l in layers])
    return M, K, N
