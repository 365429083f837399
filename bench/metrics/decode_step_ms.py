"""Mean wall of one ``step_decode`` call (it ends in the token's copy to
the host, so the device has finished), in ms."""


def read(w):
    walls = [s.t1 - s.t0 for s in w.steps if s.kind == "decode"]
    return sum(walls) / len(walls) * 1e3 if walls else None
