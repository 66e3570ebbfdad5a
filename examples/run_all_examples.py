"""Run every example as a smoke test (reference: examples/run_all_examples.py)."""

import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).parent
SKIP = {"run_all_examples.py", "_common.py"}
# timing examples, run only with --device (on the GPU)
DEVICE_ONLY = {"spmv_device.py"}


def main():
    use_device = "--device" in sys.argv
    env = dict(os.environ)
    if not use_device:
        env["JAX_PLATFORMS"] = "cpu"  # children stay off the GPU
    failed = []
    for script in sorted(HERE.glob("*.py")):
        if script.name in SKIP or (script.name in DEVICE_ONLY and not use_device):
            continue
        print(f"=== {script.name} ===", flush=True)
        r = subprocess.run([sys.executable, str(script)], env=env, cwd=str(HERE))
        if r.returncode != 0:
            failed.append(script.name)
    if failed:
        print("FAILED:", failed)
        sys.exit(1)
    print("all examples passed")


if __name__ == "__main__":
    main()
