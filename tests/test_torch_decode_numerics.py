"""The decode kernel's split-and-combine arithmetic, simulated on the CPU
at the serving shape (Hq 32, Hkv 8, D 128, pos 2048, bf16 inputs), against
the tolerance that ``chip_smoke.py`` and the ``cuda`` tests hold the kernel
to: (atol, rtol) = (1e-5, 2**-8) against the plain version run in f32.

The kernel (``kernels/csrc/decode_attention.cu``): per fixed chunk of 64
keys, f32 scores, the chunk's maximum m, P = exp(s - m) kept in f32, its
sum l and the unnormalised P V; then the chunks merged in index order with
weights exp(m_c - max m), and acc / max(l, 1e-30) rounded once to bf16.  It
must meet the tolerance.  A dropped key chunk, pos one key short or long, a
wrong KV head and P rounded to bf16 before P V must each exceed it by more
than 2x.

    python tests/test_torch_decode_numerics.py   # prints the ratios
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention_plain

torch.set_num_threads(2)
HQ, HKV, D, T, POS = 32, 8, 128, 2560, 2048
CHUNK = 64                      # keys per block of the kernel
ATOL, RTOL = 1e-5, 2.0 ** -8    # chip_smoke.TOL[torch.bfloat16]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).bfloat16()
        for shape in ((1, HQ, D), (1, HKV, T, D), (1, HKV, T, D)))


def decode_split_sim(q, k, v, pos, drop_chunk=None, kv_shift=0,
                     p_bf16=False):
    """The kernel's arithmetic on bf16 inputs, in f32.  Faults: skip key
    chunk ``drop_chunk``; query group h reads KV head (h + ``kv_shift``) %
    Hkv; round P to bf16 before P V (l still from the f32 P)."""
    hq, d = q.shape[1], q.shape[2]
    hkv = k.shape[1]
    g = hq // hkv
    out = torch.empty((1, hq, d))
    for hk in range(hkv):
        src = (hk + kv_shift) % hkv
        qg = q[0, hk * g:(hk + 1) * g].float()
        kh, vh = k[0, src].float(), v[0, src].float()
        ms, ls, accs = [], [], []
        for ci, t0 in enumerate(range(0, pos + 1, CHUNK)):
            if ci == drop_chunk:
                continue
            t1 = min(t0 + CHUNK, pos + 1)
            s = (qg @ kh[t0:t1].T) * d ** -0.5
            m = s.max(dim=1, keepdim=True).values
            p = torch.exp(s - m)
            ls.append(p.sum(dim=1, keepdim=True))
            accs.append((p.bfloat16().float() if p_bf16 else p) @ vh[t0:t1])
            ms.append(m)
        m_all = torch.stack(ms).max(dim=0).values
        l, acc = torch.zeros((g, 1)), torch.zeros((g, d))
        for m, lc, a in zip(ms, ls, accs):     # index order
            w = torch.exp(m - m_all)
            l = l + w * lc
            acc = acc + w * a
        out[0, hk * g:(hk + 1) * g] = acc / l.clamp_min(1e-30)
    return out.bfloat16()


FAULTS = {
    "drop a key chunk": dict(drop_chunk=1),
    "pos one key short": dict(pos=POS - 1),
    "pos one key long": dict(pos=POS + 1),
    "wrong KV head": dict(kv_shift=1),
    "P rounded to bf16": dict(p_bf16=True),
}


@functools.lru_cache(maxsize=None)
def ratios():
    """max |sim - ref| / (atol + rtol |ref|) for the kernel and each fault,
    ref the plain version in f32 at pos 2048."""
    q, k, v = _inputs()
    ref = decode_attention_plain(q.float(), k.float(), v.float(), POS)
    tol = ATOL + RTOL * ref.abs()
    out = {}
    for name, kw in {"kernel": {}, **FAULTS}.items():
        kw = dict(kw)
        sim = decode_split_sim(q, k, v, kw.pop("pos", POS), **kw)
        out[name] = float(((sim.float() - ref).abs() / tol).max())
    return out


def test_split_and_combine_meets_the_decode_tolerance():
    assert ratios()["kernel"] <= 1.0


@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_fault_exceeds_the_decode_tolerance(fault):
    assert ratios()[fault] > 2.0, ratios()


def test_split_sim_is_the_plain_version_in_f32():
    """With f32 inputs and no rounding of the output the chunked sum is the
    same function as the plain version, at f32 summation error."""
    q, k, v = (x.float() for x in _inputs(seed=1))
    hq, d = q.shape[1], q.shape[2]
    for pos in (0, 63, 64, 700):
        ref = decode_attention_plain(q, k, v, pos)
        sim = decode_split_sim(q, k, v, pos)
        # the simulation rounds to bf16 at its end; compare at that rounding
        torch.testing.assert_close(sim.float(), ref.bfloat16().float(),
                                   atol=1e-5, rtol=2.0 ** -7)
        assert sim.shape == (1, hq, d)


if __name__ == "__main__":
    print({name: round(r, 4) for name, r in ratios().items()})
