"""Check kind `loops`: the loop corrections of each episode, a fact of the
whole run. missed_loops: the episodes that finished inside the window with
no correction (the loop closer's count of finished corrections,
LoopCloser.stats["corrected"], unchanged from the episode's start to its
end). Every episode of a loop cell revisits its first place, so a sound run
reads 0: the number is exact. None (a failed check) where no episode
finished. run.detail["loops"] holds each episode's corrections, the last
(cut) episode's too.
"""
from __future__ import annotations


def hook(cap, run, feed):
    attach, detach = feed.attach, feed.detach
    counts = run.detail.setdefault("loops", [])
    start = {}

    def corrected(system):
        lc = system.loop_closer
        return 0 if lc is None else int(lc.stats["corrected"])

    def attach_counted(system, spans):
        start[id(system)] = corrected(system)
        attach(system, spans)

    def detach_counted(system):
        counts.append(corrected(system) - start.pop(id(system), 0))
        detach(system)

    feed.attach, feed.detach = attach_counted, detach_counted
    return [(feed, "attach", attach), (feed, "detach", detach)]


def numbers(samples, run, feed, device, control):
    done = run.detail.get("loops", [])[:run.episodes]
    if control or not done:
        return {}
    return {"missed_loops": float(sum(n == 0 for n in done))}
