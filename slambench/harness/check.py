"""What decides `correct`: samples of what the measured window produced,
compared after the window with the plain reference (slambench/reference).

The kinds of sample a cell keeps are the keys of its workload's
`check.samples`, each a module slambench/checks/<kind>.py with two
functions: `hook(cap, run, feed)` installs the kind's capture for the
window and returns the (object, attribute, original) triples to restore;
`numbers(samples, run, feed, device, control)` returns {name: value} from
what was kept ({} where nothing was). A kind may offer samples as the
window goes, or read facts of the whole run from `run`.

Capture: while the window runs, seed-drawn reservoirs keep a few of the
program's answers together with the inputs that produced them. Keeping a
sample clones its outputs and inputs; the rest pass untouched. Each kind's
reservoir has a generator of its own, drawn from the seed in the order of
the cell's `check.samples`.

Compare: the reference recomputes each sample (float32 with TF32 off, the
precision the configurations state; the solvers' costs in float64) and each
number is held to the limit in the cell's file. `control=True` puts the
reference computed with TF32 on in the program's place, in the numbers that
have such a control: the check the control must fail.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def precision(tf32):
    """Matmuls and convolutions in TF32 (`tf32`) or in full float32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Reservoir:
    """Keeps a uniform sample of at most k offers (Algorithm R) with a
    generator drawn from the seed."""

    def __init__(self, k, rng):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def slot(self):
        """Index to store the current offer at, or None to drop it."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.n))
        return j if j < self.k else None


def clone(x):
    """A copy of the tensors in x and in its lists, tuples and dicts; other
    leaves are shared."""
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(clone(v) for v in x)
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    return x


class Capture:
    """The reservoirs of one run. `active` is set only inside the window."""

    def __init__(self, seed, sizes):
        rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
        self.res = {k: Reservoir(n, np.random.default_rng(rng.integers(2 ** 63)))
                    for k, n in sizes.items()}
        self.active = False

    def claim(self, kind):
        """The reservoir slot for the current offer of `kind`, or None where
        it is dropped (or the window is closed)."""
        r = self.res.get(kind)
        if not self.active or r is None:
            return None
        return r.slot()

    def put(self, kind, j, item):
        self.res[kind].items[j] = item

    def offer(self, kind, make):
        """Offer one sample; `make()` builds it only where it is kept."""
        j = self.claim(kind)
        if j is not None:
            self.put(kind, j, make())

    def samples(self, kind):
        r = self.res.get(kind)
        return [] if r is None else [x for x in r.items if x is not None]

    def hook_function(self, module, name, kind):
        """Wrap module.name to offer (args, kwargs, output) triples. Returns
        the restore triple."""
        fn = getattr(module, name)
        cap = self

        def run(*args, **kw):
            out = fn(*args, **kw)
            cap.offer(kind, lambda: (clone(args), clone(kw), clone(out)))
            return out

        setattr(module, name, run)
        return (module, name, fn)


def judge(numbers, limits):
    """(correct, {name: {value, limit}}): every number at or under its
    limit. A number that could not be read (nothing sampled) fails."""
    table, ok = {}, True
    for name, lim in limits.items():
        v = numbers.get(name)
        table[name] = {"value": v, "limit": lim}
        if v is None or not v <= lim:
            ok = False
    return ok, table
