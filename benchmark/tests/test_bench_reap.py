"""A run ends only after every process it started: multiprocessing's
resource tracker, which the ranks' spawn leaves behind, and a grandchild
whose parent ended before it."""

import json
import subprocess
import sys

import pytest

from benchmark.spec import ROOT

CODE = """
import json, multiprocessing, subprocess, time
from benchmark import reap
reap.adopt()
p = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(0,))
p.start(); p.join()
subprocess.run(["sh", "-c", "sleep 60 &"], check=True)
time.sleep(0.5)
before = reap.children()
reap.stop_all(grace_s=2.0)
print(json.dumps({"before": len(before), "after": reap.children(), "exit": p.exitcode}))
"""


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="reads /proc")
def test_stop_all_leaves_no_process_behind():
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True, text=True,
                         timeout=120, check=True, cwd=ROOT).stdout
    got = json.loads(out.strip().splitlines()[-1])
    # the resource tracker and the orphaned sleep came back to the run
    assert got["exit"] == 0 and got["before"] == 2
    assert got["after"] == []
