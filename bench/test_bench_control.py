"""The control at a size a test run holds: on the CPU, tiny widths, three
seeds.  The program's widest gap (bf16) lies under each cell's limit, and
the fp8 control's over it and at least three times the program's.  On the
card, at the cells' own sizes: ``python3 bench/calibrate.py``."""
import io

import pytest

from bench import calibrate, harness

TINY = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2, vocab_size=2048)


@pytest.mark.parametrize("cell", ["olmo-1b.decode", "qwen1.5-4b.decode"])
def test_control_fails_program_passes(cell):
    bm = harness.load_benchmark()
    spec = harness.resolve(bm, cell)
    spec["cfg"] = dict(spec["cfg"], **TINY)
    got = calibrate.calibrate(cell, [11, 12, 13], 0.0, device="cpu", spec=spec,
                              out=io.StringIO())
    limit = spec["cell"]["gap_limit"]
    assert got["lower"] < limit < got["upper"]
    assert got["upper"] >= 3 * got["lower"]
