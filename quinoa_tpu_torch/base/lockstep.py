"""Time steps written as coroutines, driven alone or in lockstep.

A solver's step is a generator that yields a request ``(op, x)`` at each
point where the reference exchanged messages between chares: a ghost
refresh (``"halo"``), a combine of node partial sums or extremes at
chare-boundary nodes (``"sum"``, ``"max"``) or a global reduction of the
time step (``"min"``); the value sent back replaces x.  One device runs
the step alone, where every answer is x itself (run_alone); the parallel
solvers run one generator per shard and answer each round of requests
with a collective over the shards (run_lockstep).  So the per-stage code
of a single-device solver is the per-shard code of its parallel
counterpart, and not a copy of it.
"""

from __future__ import annotations


def run_alone(gen):
    """Drive a step coroutine on one device: each request is answered
    with its own value.  Returns the coroutine's return value."""
    try:
        _, x = next(gen)
        while True:
            _, x = gen.send(x)
    except StopIteration as e:
        return e.value


def run_lockstep(gens, answer):
    """Drive one step coroutine per shard in lockstep.  At each round all
    of them must make the same request; answer(op, [x_0, ..., x_{S-1}])
    returns the replies in shard order.  Returns the coroutines' return
    values in shard order."""
    S = len(gens)
    outs = [None] * S
    replies = None
    while True:
        reqs, done = [], 0
        for i, g in enumerate(gens):
            try:
                reqs.append(next(g) if replies is None
                            else g.send(replies[i]))
            except StopIteration as e:
                outs[i] = e.value
                done += 1
        if done:
            if done != S:
                raise RuntimeError("shards out of step: some finished "
                                   "their step while others wait")
            return outs
        ops = {r[0] for r in reqs}
        if len(ops) != 1:
            raise RuntimeError(f"shards out of step: requests {sorted(ops)}")
        replies = answer(reqs[0][0], [r[1] for r in reqs])
