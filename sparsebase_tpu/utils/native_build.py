"""Build of the native host libraries (``io/fastio``, ``native``).

Each library is compiled from the C++ source committed beside it, never
taken prebuilt. The flags are portable (no tuning for the build host's
CPU), so a library built on one host loads on any x86-64 host it is
copied to. A stamp file beside the library records a hash of the source and the
compile command; the library is rebuilt whenever the stamp differs, so a
library from older source or other flags is never loaded. Compilation
happens on first use and counts as set-up time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")


def build_stamp(src: Path, flags=FLAGS) -> str:
    """Hash of the source bytes and the compile flags."""
    h = hashlib.sha256(Path(src).read_bytes())
    h.update("\0".join(flags).encode())
    return h.hexdigest()


def stamp_path(lib: Path) -> Path:
    return Path(str(lib) + ".stamp")


def is_current(src: Path, lib: Path, flags=FLAGS) -> bool:
    """True when ``lib`` exists and was built from this source and flags."""
    sp = stamp_path(lib)
    return (
        Path(lib).exists()
        and sp.exists()
        and sp.read_text().strip() == build_stamp(src, flags)
    )


def ensure_built(src: Path, lib: Path, timeout: float, flags=FLAGS) -> None:
    """Compile ``src`` into ``lib`` unless the stamp says it is current.

    The library and its stamp are written to temporary names and renamed
    into place, so a concurrent process (a test worker) never loads a
    half-written file. Raises ``subprocess.CalledProcessError`` (with the
    compiler's stderr), ``subprocess.TimeoutExpired`` or ``OSError`` when
    the build cannot run.
    """
    src, lib = Path(src), Path(lib)
    if is_current(src, lib, flags):
        return
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", *flags, str(src), "-o", str(tmp)],
            check=True,
            capture_output=True,
            timeout=timeout,
        )
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    sp = stamp_path(lib)
    tmp_stamp = sp.with_name(f".{sp.name}.{os.getpid()}.tmp")
    tmp_stamp.write_text(build_stamp(src, flags) + "\n")
    os.replace(tmp_stamp, sp)
