"""What decides `correct`: samples of what the measured window produced,
compared after the window with the plain reference (slambench/reference).

Capture: while the window runs, seed-drawn reservoirs keep a few of the
program's answers together with the inputs that produced them: the
extractor's features of a frame (with the frame's image), a tracking
step's output (with the inputs the program's step received), a local BA
(the problem the mapper built, and its keyframes' poses and points as they
stand in the map after the call). Keeping a sample clones its outputs and
inputs; the rest pass untouched.

Compare: the reference recomputes each sample in float32 with TF32 off
(the precision the configurations state; the BA in float64) and each
number is held to the limit in the cell's file. `control=True` puts the reference computed with
TF32 on in the program's place: the check the control must fail.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..reference import ba as RB
from ..reference import hfnet as RH
from ..reference import tracking as RT


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


def _clone(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


class Capture:
    """The reservoirs of one run. `active` is set only inside the window."""

    def __init__(self, seed, sizes):
        rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
        self.res = {k: Reservoir(n, np.random.default_rng(rng.integers(2 ** 63)))
                    for k, n in sizes.items()}
        self.active = False

    def offer(self, kind, make):
        r = self.res.get(kind)
        if not self.active or r is None:
            return
        j = r.slot()
        if j is not None:
            r.items[j] = make()

    def samples(self, kind):
        r = self.res.get(kind)
        return [] if r is None else [x for x in r.items if x is not None]

    # ---- hooks --------------------------------------------------------------
    def hook_extractor(self, holder):
        """Wrap holder.extractor (a callable object) to offer (image,
        features) pairs."""
        ext = holder.extractor
        cap = self

        class Hooked:
            def __getattr__(self, name):
                return getattr(ext, name)

            def __call__(self, image):
                out = ext(image)
                cap.offer("extract", lambda: (image, _clone(tuple(out))))
                return out

        holder.extractor = Hooked()

    def hook_function(self, module, name, kind):
        """Wrap module.name to offer (args, output) pairs."""
        fn = getattr(module, name)
        cap = self

        def run(*args, **kw):
            out = fn(*args, **kw)
            cap.offer(kind, lambda: (_clone(args), _clone(kw), _clone(out)))
            return out

        setattr(module, name, run)
        return fn

    def hook_mapping(self, mapper_cls, ba):
        """Wrap the mapper's local BA (mapper_cls.local_ba, its
        mapper_cls._run_ba, and ba.bundle_adjust to see the problem it
        builds) to offer (problem, the problem's keyframe poses and points
        read back from the map after the call): what the solve left in the
        map, write-back included. Other BAs (map initialization, global)
        pass unsampled. Returns the originals to restore."""
        local_ba, run_ba, solve = mapper_cls.local_ba, mapper_cls._run_ba, ba.bundle_adjust
        cap, box = self, {}

        def bundle_adjust(cam_kind, cam_params, prob, *a, **kw):
            box["in"] = (cam_kind, prob)
            return solve(cam_kind, cam_params, prob, *a, **kw)

        def _local_ba(mapper, *a, **kw):
            box["local"] = True
            try:
                return local_ba(mapper, *a, **kw)
            finally:
                box.clear()

        def _run_ba(mapper, *a, **kw):
            box.pop("in", None)
            out = run_ba(mapper, *a, **kw)
            if out is not None and "in" in box and box.get("local"):
                kind, prob = box.pop("in")
                st = mapper.store

                def make():
                    if kind != 0:
                        raise ValueError("reference BA: pinhole cameras only")
                    p = {k: _clone(v) for k, v in prob._asdict().items()}
                    return (p, st.kf_R[out["kf_ids"]].copy(), st.kf_t[out["kf_ids"]].copy(),
                            st.mp_pos[out["mp_ids"]].copy())

                cap.offer("ba", make)
            return out

        ba.bundle_adjust = bundle_adjust
        mapper_cls.local_ba, mapper_cls._run_ba = _local_ba, _run_ba
        return [(ba, "bundle_adjust", solve), (mapper_cls, "_run_ba", run_ba),
                (mapper_cls, "local_ba", local_ba)]


# ---- the numbers ---------------------------------------------------------------

def extract_numbers(samples, params, ext_cfg, device, control=False):
    """kp_mismatch: the largest share of a frame's slots whose validity or
    position (1e-3 px) differs; desc_err: the largest absolute difference
    of a local descriptor entry on slots valid and placed alike in both;
    gdesc_err: the largest of a global descriptor's."""
    kp, de, ge = 0.0, 0.0, 0.0
    for image, prog in samples:
        img = torch.as_tensor(np.asarray(image), device=device)
        with precision(False):
            ref = RH.extract(params, img, ext_cfg)
        if control:
            with precision(True):
                prog = RH.extract(params, img, ext_cfg)
            prog = tuple(prog[k] for k in ("xy", "score", "octave", "desc", "mask",
                                           "global_desc"))
        xy, _, _, desc, mask, g = prog
        both = mask & ref["mask"]
        near = torch.max(torch.abs(xy - ref["xy"]), -1).values <= 1e-3
        bad = (mask != ref["mask"]) | (both & ~near)
        kp = max(kp, float(bad.float().mean()))
        ok = both & near
        if bool(ok.any()):
            de = max(de, float(torch.max(torch.abs(desc[ok] - ref["desc"][ok]))))
        ge = max(ge, float(torch.max(torch.abs(g.float() - ref["global_desc"]))))
    return {"kp_mismatch": kp, "desc_err": de, "gdesc_err": ge}


def _ref_track(args, tf32):
    (kind, cam, W, H, R0, t0, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_valid, motion_ids,
     local_ids, xy, desc, octave, mask, z, wz, cfg) = args
    if kind != 0:
        raise ValueError("reference tracking step: pinhole cameras only")
    with precision(tf32):
        return RT.track_step(cam, W, H, R0, t0, m_pos, m_desc, m_normal, m_dmin, m_dmax,
                             m_valid, motion_ids, local_ids, xy, desc, octave, mask, z, wz,
                             cfg._asdict())


def track_numbers(samples, control=False):
    """obs_mismatch: the largest share of a step's slots whose final map
    point differs; pose_err: the largest absolute difference of an entry
    of the final [R | t]."""
    om, pe = 0.0, 0.0
    for args, kw, out in samples:
        ref = _ref_track(args, False)
        if control:
            out = _ref_track(args, True)
        om = max(om, float((out["obs"].long() != ref["obs"].long()).float().mean()))
        pe = max(pe, float(torch.max(torch.abs(out["R"] - ref["R"]))),
                 float(torch.max(torch.abs(out["t"] - ref["t"]))))
    return {"obs_mismatch": om, "pose_err": pe}


def ba_numbers(samples, camera, detail=None):
    """ba_excess: the largest share of a sampled local BA's reducible cost
    that the program left in the map (reference/ba.excess, float64; the
    camera's intrinsics from the configuration). `detail` collects each
    sample's (share, C_in, C_out, C_ref)."""
    worst = 0.0
    for p, R1, t1, P1 in samples:
        dev = p["poses_R"].device
        cam = torch.tensor([camera[k] for k in ("fx", "fy", "cx", "cy")], dtype=torch.float64,
                           device=dev)
        R, t, P = p["poses_R"].clone(), p["poses_t"].clone(), p["points"].clone()
        R[:len(R1)] = torch.as_tensor(R1, device=dev)
        t[:len(t1)] = torch.as_tensor(t1, device=dev)
        P[:len(P1)] = torch.as_tensor(P1, device=dev)
        with precision(False):
            x, costs = RB.excess(cam, p, R, t, P)
        worst = max(worst, x)
        if detail is not None:
            detail.append((x,) + costs)
    return {"ba_excess": worst}


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
