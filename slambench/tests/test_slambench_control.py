"""The control on the card: on the same window samples the program passes
every limit and the reference computed with TF32 on fails one, on three
seeds, at the small sizes of _small.py. (At the cells' own sizes:
python3 slambench/control.py, whose readings PERF.md keeps.)"""
import pytest

from slambench.harness import core

from _small import ORBIT


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23])
def test_control_fails_where_the_program_passes(card, seed):
    name, over = ORBIT
    box = {}
    result, table = core.run(name, seed, 4, False, device=card, overrides=over, control=True,
                             run_out=box, log=lambda *a: None)
    assert result["correct"], table
    assert not all(r["value"] is not None and r["value"] <= r["limit"]
                   for r in box["control"].values()), box["control"]
