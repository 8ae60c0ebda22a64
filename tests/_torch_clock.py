"""A fixed wall clock for the serving runtime in tests. Which rows a batch
holds, which cache path a request takes and which version a live-index
answer sees all follow the runtime's measured service times; a clock that
reads a fixed step more at every reading makes a trace run the same way on
every machine, and in both packages. No JAX here: the card's tests use it."""
import itertools
import types

STEP_S = 2.0 ** -9       # a power of two, so every difference is exact


def fix_clocks(monkeypatch, *modules, step_s: float = STEP_S):
    """Replace each module's ``time`` by a clock whose ``perf_counter``
    reads ``step_s`` more than its previous reading, counting from 0 anew
    for each module and on each call."""
    for mod in modules:
        tick = itertools.count()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda tick=tick: next(tick) * step_s))
