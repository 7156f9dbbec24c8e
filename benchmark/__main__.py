"""``python -m benchmark --workload <cell> --seed <n> --seconds <s> --trace <0|1>``:
one run of one cell of ``BENCHMARK.json`` on this machine's cards."""

import time

_TOP = time.monotonic()  # before any import: set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Python's bytecode cache in a fixed directory of the checkout, for this
# process and every process it starts (a gate pass, a rank): only the first
# run in a checkout compiles torch's sources, as a node's image ships them
# compiled.  An environment that forbids writing bytecode would make every
# process compile them again (~6 s a process on the card machine).
PYCACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_pycache")
sys.dont_write_bytecode = False
sys.pycache_prefix = PYCACHE
os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE


def _started() -> float:
    """time.monotonic() at this process's start: the interpreter's own
    start-up before this module ran is read from /proc (0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age if age >= 0 else _TOP
    except (OSError, ValueError, IndexError):
        return _TOP


def main(argv=None) -> int:
    started = _started()
    parser = argparse.ArgumentParser(prog="python -m benchmark")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import reap
    from benchmark.harness import execute, finish
    from benchmark.spec import Spec

    reap.adopt()

    spec = Spec()
    chips = int(spec.workload(args.workload)["chips"])
    import torch

    # the count only: nothing here makes a CUDA context on a rank's card
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"available {torch.cuda.is_available()}, count {torch.cuda.device_count()}",
              file=sys.stderr, flush=True)
        return 2
    try:
        outcome = execute(spec, args.workload, args.seed, args.seconds, bool(args.trace), started)
    finally:
        # the ranks' launcher leaves multiprocessing's resource tracker
        # running: every process this run started ends before its line
        reap.stop_all()
    return finish(spec, args.workload, outcome, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
