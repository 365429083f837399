"""Mean host time of the engine's CHECKPOINT (``engine.checkpoint``: the
state's stream sync and the KV pool's resize), over the window's
checkpoints, in ms.  Read from ``repro_torch.obs.host``; nothing where it
holds no checkpoint."""


def read(w):
    try:
        from repro_torch.obs import host
    except ImportError:          # a program without the recorder
        return None
    lo, hi = int(w.rounds[0][0] * 1e9), int(w.rounds[-1][1] * 1e9)
    ckpt = [t1 - t0 for _, t0, t1, _ in host.spans(lo, hi, "engine.checkpoint")]
    return sum(ckpt) / len(ckpt) / 1e6 if ckpt else None
