"""95th percentile of a batch's latency in the closed-loop stream: from
when the harness hands the batch to `stream_roundtrip` to when its x_hats
are complete on the device (a watcher thread's stamp), over the window's
batches outside the profiled slice. In a closed loop at the card's pace
it follows the stream's depth and throughput, so it has no bound."""

import statistics

LAYER = "Stream (models/streaming.py)"
UNIT = "ms"
MOVES = "stream_mps"
SOURCE = "host_clock"


def read(r):
    if len(r.latencies_s) < 20:
        return None
    return 1e3 * statistics.quantiles(r.latencies_s, n=20)[18]
