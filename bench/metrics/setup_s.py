"""Process start to the first round's start: imports, the kernel library
(built in the checkout's build/ on a first run), the weights drawn on the
card, and the warm round."""


def read(w):
    return w.setup_s
