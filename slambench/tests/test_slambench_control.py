"""The control on the card: on the same window samples the reference
computed with TF32 on fails a limit that the program passes, on three
seeds, at the small sizes of _small.py, in each cell; on the orbit the
program passes every limit (the revisit's Sim3 refinement may not: PERF.md
section 7). (At the cells' own sizes: python3 slambench/control.py, whose
readings PERF.md keeps.)"""
import pytest

from slambench.harness import core

from _small import ORBIT, REVISIT


@pytest.mark.cuda
@pytest.mark.parametrize("cell, seconds", [(ORBIT, 4), (REVISIT, 12)], ids=["orbit", "revisit"])
@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23])
def test_control_fails_where_the_program_passes(card, seed, cell, seconds):
    name, over = cell
    box = {}
    result, table = core.run(name, seed, seconds, False, device=card, overrides=over,
                             control=True, run_out=box, log=lambda *a: None)

    def passes(row):
        return row["value"] is not None and row["value"] <= row["limit"]

    assert result["correct"] or cell is REVISIT, table
    assert any(passes(table[k]) and not passes(box["control"][k]) for k in table), \
        (table, box["control"])
