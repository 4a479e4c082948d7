"""Worker process for the real multi-process multi-host test.

Launched by tests/test_multihost.py as N separate OS processes joined by
jax.distributed over a local Gloo coordinator — the CPU-backend analogue
of a multi-host accelerator cluster (SURVEY §4: "multi-host tests via multi-process
jax.distributed simulation on CPU"). Each process holds only its
host-local slice of the input and must still produce the byte-exact
single-chip stream.

Usage: python mp_worker.py <port> <process_id> <num_processes> <out_file>
"""

import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cases():
    import numpy as np

    rng = np.random.default_rng(20260818)
    cases = []
    # rowmajor-only ndims (>4 u8 / >2 u16 so encoder.compress matches the
    # rowmajor-only mp path); sizes chosen to exercise padding + tails
    for codec, dt, ndims, n in [
        ("delta", np.uint8, 7, 7 * 8 * 53 + 11),
        ("xff", np.uint8, 5, 5 * 8 * 40),
        ("delta", np.uint16, 6, 6 * 8 * 37 + 5),
    ]:
        flat = rng.integers(0, 50, size=n, dtype=dt)
        # a constant run -> zero deltas -> RLE coverage across the
        # process boundary
        flat[n // 3: n // 3 + 800] = 7
        cases.append((codec, dt, ndims, flat))
    return cases


def main() -> None:
    port, pid, nproc, out_file = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc, process_id=pid)

    import numpy as np

    from sprintz_jax import encoder
    from sprintz_jax.parallel import multihost as mh

    assert jax.process_count() == nproc
    mesh = mh.global_mesh()
    checked = []
    for codec, dt, ndims, flat in _cases():
        n = flat.size
        elem_sz = dt().itemsize
        expected = encoder.compress(flat, ndims, codec=codec)
        sl = mh.host_local_elems(n, ndims)
        got = mh.mp_compress(flat[sl].copy(), n, ndims, codec=codec,
                             mesh=mesh)
        assert got == expected, (
            f"mp_compress stream mismatch ({codec}/{dt.__name__}/d{ndims}) "
            f"len {len(got)} vs {len(expected)}")
        dec = mh.mp_decompress(expected, codec=codec, elem_sz=elem_sz,
                               mesh=mesh)
        assert np.array_equal(dec, flat), (
            f"mp_decompress mismatch ({codec}/{dt.__name__}/d{ndims})")
        checked.append(f"{codec}/{dt.__name__}/d{ndims}")

    with open(out_file, "w") as f:
        f.write("OK " + " ".join(checked) + "\n")


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
