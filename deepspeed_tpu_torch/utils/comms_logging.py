"""Per-collective communication logging (port of
``deepspeed_tpu/utils/comms_logging.py``).

``CommsLogger`` keeps per-op counts, message sizes, latency and algorithmic
/ bus bandwidth, fed by the ``timed_op`` wrapper in ``comm/comm.py``.  The
message size is read from torch tensors (``numel() * element_size()``) as
well as from arrays with ``size`` / ``dtype.itemsize``.
"""

import math
from collections import defaultdict

from deepspeed_tpu_torch.utils.logging import log_dist


def _nbytes(a):
    numel = getattr(a, "numel", None)
    if callable(numel) and callable(getattr(a, "element_size", None)):
        return int(numel()) * int(a.element_size())
    size = getattr(a, "size", None)
    itemsize = getattr(getattr(a, "dtype", None), "itemsize", None)
    if size is not None and not callable(size) and itemsize is not None:
        return int(size) * int(itemsize)
    return 0


def get_msg_size_from_args(arrays):
    """Total payload bytes of the tensors involved in a collective."""
    leaves = arrays if isinstance(arrays, (list, tuple)) else [arrays]
    return sum(_nbytes(a) for a in leaves)


def calc_bw_log(comm_op, size, duration):
    """algbw/busbw in GB/s — same correction factors as the reference
    (``comms_logging.py`` ring-algorithm factors)."""
    n = max(duration, 1e-9)
    algbw = size / n
    if comm_op in ("all_reduce",):
        busbw = algbw * 2  # ring allreduce moves ~2x payload
    else:
        busbw = algbw
    return algbw / 1e9, busbw / 1e9


class CommsLogger:

    def __init__(self, verbose=False, debug=False, prof_ops=None,
                 enabled=False):
        self.enabled = enabled
        self.verbose = verbose
        self.debug = debug
        self.prof_all = True
        self.prof_ops = prof_ops or []
        self.comms_dict = defaultdict(
            lambda: defaultdict(lambda: [0, 0.0, 0.0, 0.0]))

    def configure(self, comms_config):
        self.enabled = comms_config.enabled
        self.verbose = comms_config.verbose
        self.debug = comms_config.debug
        self.prof_all = comms_config.prof_all
        self.prof_ops = comms_config.prof_ops

    def append(self, raw_name, record_name, latency, msg_size):
        algbw, busbw = calc_bw_log(raw_name, msg_size, latency)
        entry = self.comms_dict[record_name][msg_size]
        entry[0] += 1
        entry[1] += latency
        entry[2] += algbw
        entry[3] += busbw
        if self.verbose:
            log_dist(
                f"comm op: {record_name} | time (ms): {latency*1e3:.2f} | "
                f"msg size: {msg_size} | algbw (GB/s): {algbw:.2f} | "
                f"busbw (GB/s): {busbw:.2f}", ranks=[0])

    def reset(self):
        self.comms_dict.clear()

    def totals(self):
        """``{record name: {"count", "bytes", "seconds"}}`` over every
        message size."""
        out = {}
        for name, sizes in self.comms_dict.items():
            out[name] = {
                "count": sum(e[0] for e in sizes.values()),
                "bytes": sum(size * e[0] for size, e in sizes.items()),
                "seconds": sum(e[1] for e in sizes.values())}
        return out

    def log_all(self):
        header = (f"{'Comm. Op':<20}{'Message Size':>15}{'Count':>10}"
                  f"{'Total Lat(ms)':>16}{'Avg Lat(ms)':>14}"
                  f"{'algbw(GB/s)':>14}{'busbw(GB/s)':>14}")
        lines = [header]
        for record_name, sizes in sorted(self.comms_dict.items()):
            for size, (count, lat, algbw, busbw) in sorted(sizes.items()):
                lines.append(
                    f"{record_name:<20}{_fmt_size(size):>15}{count:>10}"
                    f"{lat*1e3:>16.2f}{lat*1e3/max(count,1):>14.2f}"
                    f"{algbw/max(count,1):>14.2f}{busbw/max(count,1):>14.2f}")
        log_dist("\n".join(lines), ranks=[0])
        return "\n".join(lines)


def _fmt_size(num_bytes):
    if num_bytes == 0:
        return "0B"
    units = ("B", "KB", "MB", "GB", "TB")
    i = min(int(math.log(num_bytes, 1024)), len(units) - 1)
    return f"{num_bytes / (1024 ** i):.2f} {units[i]}"
