"""Wall seconds of a ``chip_smoke.py`` run by function: every function the
script defines at module level is wrapped so that its calls' wall time
adds to its name (while one call runs, nested and concurrent calls of
the same function add nothing), and the table prints as one ``[phases]``
line. ``chip_smoke.py`` times itself this way; this script times another
checkout's smoke the same way, so two runs compare phase by phase:

    python3 revisit_anything_tpu_torch/kernels/smoke_phases.py ROOT

runs ROOT's ``chip_smoke.py`` (the parent's from ``git archive``, say) from
ROOT with its functions timed and prints ``[phases]`` after its output
(also when it fails). Nothing of the package is imported here, so the
smoke loads ROOT's own package. Functions under ``least`` seconds are
left out of the line.
"""

from __future__ import annotations

import functools
import importlib.util
import inspect
import os
import sys
import threading
import time


def time_functions(ns: dict, seconds: dict) -> None:
    """Wrap, in place, every function of the module namespace ``ns``
    defined in that module; each wrapped function's wall seconds add to
    ``seconds[name]``."""
    lock = threading.Lock()
    active: dict = {}
    started: dict = {}

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with lock:
                active[name] = active.get(name, 0) + 1
                if active[name] == 1:
                    started[name] = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    active[name] -= 1
                    if active[name] == 0:
                        seconds[name] = (seconds.get(name, 0.0)
                                         + time.perf_counter() - started[name])
        return timed

    for name, obj in list(ns.items()):
        if inspect.isfunction(obj) and obj.__module__ == ns["__name__"]:
            ns[name] = wrap(name, obj)


def report(seconds: dict, least: float = 0.5) -> str:
    """The ``[phases]`` line: the functions of at least ``least`` seconds,
    longest first."""
    items = sorted(((s, n) for n, s in seconds.items() if s >= least),
                   reverse=True)
    return ("[phases] wall seconds by function (a call's nested calls of "
            "the same function not added again): "
            + ", ".join(f"{n} {s:.1f}" for s, n in items))


def main(root: str) -> int:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    seconds: dict = {}
    time_functions(vars(smoke), seconds)
    t0 = time.perf_counter()
    rc = 0
    try:
        smoke.main()
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    finally:
        print(report(seconds), flush=True)
        print(f"[phases] the whole run {time.perf_counter() - t0:.1f} s, "
              f"rc {rc}", flush=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
