"""One-command local validation on the CPU: full pytest, examples,
graft-entry dryrun, and the visualizer CLI. Exit 0 iff everything passes:

    python tools/verify_all.py [--quick]

--quick skips the full pytest (runs the fast core subset instead).
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).parent.parent


def run(name, cmd, env=None, timeout=2400):
    print(f"== {name}: {' '.join(cmd)}", flush=True)
    e = dict(os.environ)
    if env:
        e.update(env)
    r = subprocess.run(cmd, cwd=REPO, env=e, timeout=timeout)
    if r.returncode != 0:
        print(f"FAILED: {name}", flush=True)
        sys.exit(1)


def main():
    quick = "--quick" in sys.argv
    py = sys.executable
    if quick:
        run(
            "pytest (core subset)",
            [py, "-m", "pytest", "tests/test_convert.py", "tests/test_formats.py",
             "tests/test_reorder.py", "tests/test_partition.py", "-q"],
        )
    else:
        run("pytest (full)", [py, "-m", "pytest", "tests/", "-q"])
    run("examples", [py, "examples/run_all_examples.py"])
    # dryrun branch only: it pins the CPU, so the run never opens a GPU
    run(
        "graft multichip dryrun (CPU mesh)",
        [py, "__graft_entry__.py"],
        env={
            "_GRAFT_DRYRUN": "1",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        },
    )
    run(
        "visualizer CLI",
        [py, "-m", "sparsebase_tpu.utils.visualizer",
         "tests/golden/ash958_sym.mtx", str(Path(tempfile.gettempdir()) / "viz_check.html"),
         "--orderings", "rcm", "--parts", "16"],
    )
    print("ALL LOCAL VALIDATION GREEN", flush=True)


if __name__ == "__main__":
    main()
