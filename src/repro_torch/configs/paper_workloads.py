# Copied from src/repro/configs/paper_workloads.py; `repro.` rewritten to `repro_torch.`.
"""The paper's eight benchmark DNNs (§III) as lowered op lists.

Four CNNs — AlexNet, GoogLeNet, VGGNet, MobileNet (CNN-AN/GN/VN/MN) — and
four LSTM RNNs — sentiment analysis (RNN-SA, linear in/out length), two
machine-translation seq2seq instances (RNN-MT1/MT2, non-linear length), and
a Listen-Attend-Spell speech recognizer (RNN-ASR).

Topologies are reconstructed from the public architectures; exact layer
dimensions follow the original papers.  These descriptors drive the
figure-reproduction benchmarks on the paper's Table-I NPU model.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

from repro_torch.core.ops import (NetworkDesc, VectorOp, conv2d,
                            depthwise_conv2d, fc, lstm_cell)


# --------------------------------------------------------------------------
# CNNs
# --------------------------------------------------------------------------
def _alexnet() -> NetworkDesc:
    ops = [
        conv2d("conv1", 3, 96, 11, 11, 55, 55), VectorOp(96 * 55 * 55, "relu1"),
        conv2d("conv2", 96, 256, 5, 5, 27, 27), VectorOp(256 * 27 * 27, "relu2"),
        conv2d("conv3", 256, 384, 3, 3, 13, 13), VectorOp(384 * 13 * 13, "relu3"),
        conv2d("conv4", 384, 384, 3, 3, 13, 13), VectorOp(384 * 13 * 13, "relu4"),
        conv2d("conv5", 384, 256, 3, 3, 13, 13), VectorOp(256 * 13 * 13, "relu5"),
        fc("fc6", 9216, 4096), VectorOp(4096, "relu6"),
        fc("fc7", 4096, 4096), VectorOp(4096, "relu7"),
        fc("fc8", 4096, 1000),
    ]
    return NetworkDesc("CNN-AN", tuple(ops), kind="cnn")


def _vggnet() -> NetworkDesc:
    plan = [  # (in_c, out_c, spatial)
        (3, 64, 224), (64, 64, 224),
        (64, 128, 112), (128, 128, 112),
        (128, 256, 56), (256, 256, 56), (256, 256, 56),
        (256, 512, 28), (512, 512, 28), (512, 512, 28),
        (512, 512, 14), (512, 512, 14), (512, 512, 14),
    ]
    ops: List = []
    for i, (ic, oc, sp) in enumerate(plan):
        ops.append(conv2d(f"conv{i}", ic, oc, 3, 3, sp, sp))
        ops.append(VectorOp(oc * sp * sp, f"relu{i}"))
    ops += [fc("fc6", 25088, 4096), VectorOp(4096),
            fc("fc7", 4096, 4096), VectorOp(4096),
            fc("fc8", 4096, 1000)]
    return NetworkDesc("CNN-VN", tuple(ops), kind="cnn")


def _inception(name: str, in_c: int, sp: int,
               b1: int, b2a: int, b2b: int, b3a: int, b3b: int, b4: int
               ) -> List:
    """GoogLeNet inception module: 1x1 / 1x1->3x3 / 1x1->5x5 / pool->1x1."""
    ops = [
        conv2d(f"{name}.b1", in_c, b1, 1, 1, sp, sp),
        conv2d(f"{name}.b2a", in_c, b2a, 1, 1, sp, sp),
        conv2d(f"{name}.b2b", b2a, b2b, 3, 3, sp, sp),
        conv2d(f"{name}.b3a", in_c, b3a, 1, 1, sp, sp),
        conv2d(f"{name}.b3b", b3a, b3b, 5, 5, sp, sp),
        conv2d(f"{name}.b4", in_c, b4, 1, 1, sp, sp),
        VectorOp((b1 + b2b + b3b + b4) * sp * sp, f"{name}.concat"),
    ]
    return ops


def _googlenet() -> NetworkDesc:
    ops: List = [
        conv2d("conv1", 3, 64, 7, 7, 112, 112), VectorOp(64 * 112 * 112),
        conv2d("conv2a", 64, 64, 1, 1, 56, 56),
        conv2d("conv2b", 64, 192, 3, 3, 56, 56), VectorOp(192 * 56 * 56),
    ]
    ops += _inception("3a", 192, 28, 64, 96, 128, 16, 32, 32)
    ops += _inception("3b", 256, 28, 128, 128, 192, 32, 96, 64)
    ops += _inception("4a", 480, 14, 192, 96, 208, 16, 48, 64)
    ops += _inception("4b", 512, 14, 160, 112, 224, 24, 64, 64)
    ops += _inception("4c", 512, 14, 128, 128, 256, 24, 64, 64)
    ops += _inception("4d", 512, 14, 112, 144, 288, 32, 64, 64)
    ops += _inception("4e", 528, 14, 256, 160, 320, 32, 128, 128)
    ops += _inception("5a", 832, 7, 256, 160, 320, 32, 128, 128)
    ops += _inception("5b", 832, 7, 384, 192, 384, 48, 128, 128)
    ops.append(fc("fc", 1024, 1000))
    return NetworkDesc("CNN-GN", tuple(ops), kind="cnn")


def _mobilenet() -> NetworkDesc:
    ops: List = [conv2d("conv1", 3, 32, 3, 3, 112, 112),
                 VectorOp(32 * 112 * 112)]
    plan = [  # (channels_in, channels_out, spatial_out)
        (32, 64, 112), (64, 128, 56), (128, 128, 56), (128, 256, 28),
        (256, 256, 28), (256, 512, 14), (512, 512, 14), (512, 512, 14),
        (512, 512, 14), (512, 512, 14), (512, 512, 14), (512, 1024, 7),
        (1024, 1024, 7),
    ]
    for i, (ic, oc, sp) in enumerate(plan):
        ops.append(depthwise_conv2d(f"dw{i}", ic, 3, 3, sp, sp))
        ops.append(conv2d(f"pw{i}", ic, oc, 1, 1, sp, sp))
        ops.append(VectorOp(oc * sp * sp, f"relu{i}"))
    ops.append(fc("fc", 1024, 1000))
    return NetworkDesc("CNN-MN", tuple(ops), kind="cnn")


# --------------------------------------------------------------------------
# RNNs
# --------------------------------------------------------------------------
def _rnn_sa() -> NetworkDesc:
    """Sentiment analysis: 2-layer LSTM (hidden 1024) over the input, then a
    classifier.  Total node count is linear in input length (Fig 8(b))."""
    embed = [fc("embed", 1024, 1024)]
    cell = lstm_cell("l0", 1024, 1024) + lstm_cell("l1", 1024, 1024)
    static = tuple(embed + [fc("cls", 1024, 2)])
    return NetworkDesc("RNN-SA", static, encoder_ops=tuple(cell),
                       kind="rnn_linear")


def _rnn_mt(idx: int) -> NetworkDesc:
    """Machine translation: 4-layer seq2seq LSTM, hidden 1024 (GNMT-like).
    Encoder unrolls in_len times (statically known); the *decoder* unroll
    count is the dynamically-predicted quantity (Fig 8(c))."""
    enc_cell = (lstm_cell("enc0", 1024, 1024) + lstm_cell("enc1", 1024, 1024)
                + lstm_cell("enc2", 1024, 1024) + lstm_cell("enc3", 1024, 1024))
    dec_cell = (lstm_cell("dec0", 2048, 1024) + lstm_cell("dec1", 1024, 1024)
                + lstm_cell("dec2", 1024, 1024) + lstm_cell("dec3", 1024, 1024)
                + [fc("attn", 1024, 1024), fc("proj", 1024, 30000)])
    return NetworkDesc(f"RNN-MT{idx}", (), encoder_ops=tuple(enc_cell),
                       recurrent_ops=tuple(dec_cell), kind="rnn_seq2seq")


def _rnn_asr() -> NetworkDesc:
    """Listen-Attend-Spell: pyramidal BLSTM listener (3x512, per input
    frame) + 2-layer LSTM speller with attention (dynamic unroll)."""
    listener = (lstm_cell("lis0f", 512, 512) + lstm_cell("lis0b", 512, 512)
                + lstm_cell("lis1f", 512, 512) + lstm_cell("lis1b", 512, 512)
                + lstm_cell("lis2f", 512, 512) + lstm_cell("lis2b", 512, 512))
    speller = (lstm_cell("spel0", 1024, 512) + lstm_cell("spel1", 512, 512)
               + [fc("attn", 512, 512), fc("chars", 512, 64)])
    return NetworkDesc("RNN-ASR", (), encoder_ops=tuple(listener),
                       recurrent_ops=tuple(speller), kind="rnn_seq2seq")


# --------------------------------------------------------------------------
# Registry + profiled length distributions (Fig 9 characterization)
# --------------------------------------------------------------------------
_BUILDERS = {
    "CNN-AN": _alexnet, "CNN-GN": _googlenet, "CNN-VN": _vggnet,
    "CNN-MN": _mobilenet, "RNN-SA": _rnn_sa,
    "RNN-MT1": functools.partial(_rnn_mt, 1),
    "RNN-MT2": functools.partial(_rnn_mt, 2),
    "RNN-ASR": _rnn_asr,
}

WORKLOAD_NAMES = tuple(_BUILDERS)


def get_network(name: str) -> NetworkDesc:
    return _BUILDERS[name]()


# Non-linear input→output length ratios (geomean, spread) mirroring the
# paper's Fig 9: En→De ≈ 1.1x, En→Ko ≈ 0.8x, speech ≈ transcript chars.
_LENGTH_MODELS = {
    "RNN-MT1": (1.10, 0.18),   # English→German
    "RNN-MT2": (0.80, 0.22),   # English→Korean
    "RNN-ASR": (1.50, 0.25),   # frames→characters (after pyramid folding)
}


def profile_length_pairs(name: str, rng: np.random.Generator,
                         n_samples: int = 1500,
                         in_lengths: Tuple[int, ...] = tuple(range(4, 61, 2)),
                         ) -> List[Tuple[int, int]]:
    """Synthesize the Fig-9 profiling dataset: for each input length, draw
    output lengths log-normally around ratio*in_len.  This stands in for the
    WMT/LibriSpeech profiling runs of the paper (1500 samples/model)."""
    ratio, sigma = _LENGTH_MODELS[name]
    pairs = []
    for _ in range(n_samples):
        il = int(rng.choice(in_lengths))
        ol = max(1, int(round(il * ratio * float(rng.lognormal(0.0, sigma)))))
        pairs.append((il, ol))
    return pairs
