"""Parse-throughput benchmark at the ingest scale (SURVEY.md §7 hard
part 6: "MTX parsing throughput for 100M-nnz inputs").

Generates a large pattern .mtx once (default 50M nnz) in the temporary
directory with the in-repo ``MTXWriter``, then measures nnz/s for:

  * fastio (mmap + OpenMP native parse, the PIGO-parity path;
    reference: external/pigo/pigo.hpp + io/pigo_mtx_reader.cc)
  * the pure-Python MTXReader (numpy loadtxt path) — on a 5M-nnz
    slice, since the full file takes minutes

Host only: the parsed arrays stay on the host (``chip_smoke.py`` phase
E times the read through to a device CSR).

    python tools/bench_ingest.py [nnz_millions]
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def write_mtx(path: Path, n: int, nnz: int, seed: int = 0) -> None:
    print(f"generating {path} ({nnz/1e6:.0f}M nnz)...", flush=True)
    from sparsebase_tpu import COO
    from sparsebase_tpu.io.mtx import MTXWriter

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    MTXWriter(str(path), field="pattern").write_coo(COO(rows, cols, None, (n, n)))


def main():
    from sparsebase_tpu.io.mtx import MTXReader
    from sparsebase_tpu.io.pigo import PigoMTXReader, _fastio_enabled

    nnz_m = float(sys.argv[1]) if len(sys.argv) > 1 else 50.0
    nnz = int(nnz_m * 1e6)
    n = max(nnz // 16, 1)

    tmp = Path(tempfile.gettempdir())
    big = tmp / f"ingest_{int(nnz_m)}m.mtx"
    small = tmp / "ingest_5m.mtx"
    if not big.exists():
        write_mtx(big, n, nnz)
    if not small.exists():
        write_mtx(small, max(5_000_000 // 16, 1), 5_000_000)
    print(f"file size: {big.stat().st_size/1e9:.2f} GB")
    assert _fastio_enabled(), "fastio extension not built"

    def bench(reader_cls, path, count, reps=2, label=""):
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            coo = reader_cls(str(path)).read_coo()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
            assert coo.nnz == count, (coo.nnz, count)
        print(f"{label:42s} {best:8.2f} s   {count/best/1e6:8.1f} M nnz/s")
        return best

    bench(PigoMTXReader, small, 5_000_000, reps=3,
          label="fastio parse 5M nnz")
    bench(MTXReader, small, 5_000_000, reps=1,
          label="python MTXReader 5M nnz (naive baseline)")
    bench(PigoMTXReader, big, nnz, reps=2,
          label=f"fastio parse {nnz_m:.0f}M nnz (end-to-end)")

    # raw parse kernel with reused (warm) buffers: isolates the parser
    # from first-touch page faults and the downstream COO sort
    import ctypes

    from sparsebase_tpu.io import fastio
    from sparsebase_tpu.io.pigo import _body_offset

    off, _ = _body_offset(str(big))
    n = fastio.count_entries(str(big), off)
    buffers = (np.zeros(n, np.int64), np.zeros(n, np.int64), None)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        rows, cols, _v = fastio.parse_entries(str(big), off, False, out=buffers)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    print(f"{'fastio RAW parse, warm buffers':42s} {best:8.2f} s   "
          f"{n/best/1e6:8.1f} M nnz/s")


if __name__ == "__main__":
    main()
