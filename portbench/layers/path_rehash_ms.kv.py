"""path_rehash_ms.kv: device time per launch of ``path_rehash_kernel``
(``csrc/merkle_paths.cu``) in the traced sub-window, by kernel name, in ms.
Moves ``fresh_p95_ms``."""

from portbench.devtrace import kernel_stats


def read(r):
    if r.summary is None:
        return None
    secs, launches = kernel_stats(r.summary, "path_rehash")
    if launches == 0:
        return None
    r.ctx.log(f"[path_rehash] {launches} launches, {1e3 * secs:.6f} ms in all")
    return 1e3 * secs / launches
