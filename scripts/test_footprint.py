"""The disk footprint of the port's tests: what they leave, and their peak.

Runs every ``tests/test_torch_*.py`` of a checkout with the tier-1 flags
(``-m 'not slow' -p xdist -n 6 --dist loadfile``) and ``--basetemp DIR``,
samples ``du -sm DIR`` every 15 s while the run lasts, and prints one JSON
object: the pytest exit code, the counts of its summary line, the run's
seconds, the megabytes left under ``DIR`` when it ended, the largest
sample and the largest test directories at that sample. Run from anywhere:

    python scripts/test_footprint.py --repo . --basetemp /path/to/empty_dir \\
        [--out result.json] [--workers 6]

``DIR`` is emptied by pytest when the run starts; give one that nothing
else uses.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import threading
import time


def du_mb(path: str) -> int:
    """``du -sm path``, 0 while the directory does not exist."""
    if not os.path.exists(path):
        return 0
    out = subprocess.run(["du", "-sm", path], capture_output=True, text=True).stdout.split()
    return int(out[0]) if out else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repo", default=".")
    p.add_argument("--basetemp", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--every", type=float, default=15.0, help="seconds between samples")
    args = p.parse_args(argv)

    repo = os.path.abspath(args.repo)
    base = os.path.abspath(args.basetemp)
    files = sorted(os.path.relpath(f, repo) for f in glob.glob(os.path.join(repo, "tests", "test_torch_*.py")))
    cmd = [sys.executable, "-m", "pytest", *files, "-q", "-m", "not slow", "--continue-on-collection-errors",
           "-p", "no:cacheprovider", "-p", "xdist", "-n", str(args.workers), "--dist", "loadfile",
           "-p", "no:randomly", "--basetemp", base]
    env = dict(os.environ, JAX_PLATFORMS="cpu", ALLOW_MULTIPLE_LIBTPU_LOAD="1")
    samples = []
    done = threading.Event()

    top = {}  # at the largest sample: the directories of each worker's tests, by size

    def sample():
        while not done.wait(args.every):
            samples.append(du_mb(base))
            if samples[-1] == max(samples):
                dirs = glob.glob(os.path.join(base, "*", "*"))
                out = subprocess.run(["du", "-sm", *dirs], capture_output=True, text=True).stdout if dirs else ""
                sizes = [line.split("\t") for line in out.splitlines()]
                top.clear()
                largest = sorted(sizes, key=lambda x: -int(x[0]))[:8]
                top.update({os.path.relpath(p, base): int(mb) for mb, p in largest})

    t0 = time.perf_counter()
    watcher = threading.Thread(target=sample, daemon=True)
    watcher.start()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True)
    done.set()
    watcher.join()
    seconds = time.perf_counter() - t0
    left = du_mb(base)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    counts = {k: int(n) for n, k in re.findall(r"(\d+) (passed|failed|skipped|errors?|xfailed|xpassed)", tail)}
    result = dict(rc=proc.returncode, summary=tail, counts=counts, files=len(files), seconds=round(seconds, 1),
                  left_mb=left, peak_mb=max(samples + [left]), samples=len(samples), at_peak_mb=top)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(result, stdout_tail=proc.stdout[-20000:], stderr_tail=proc.stderr[-5000:]), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
