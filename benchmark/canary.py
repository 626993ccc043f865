"""The launch-latency canary: a captured chain of one-element additions.

A CUDA graph of ``KERNELS`` dependent one-element additions measures the
card's latency from one kernel to the next and nothing else.  The H100
has been seen to hold one of two levels about 0.3 us apart for seconds to
a minute (1.07 or 1.3 us per kernel), which moves a pass of ~257 small
kernels by about 85 us; the reading before and after each window tells
which level a run saw.
"""

from __future__ import annotations

import torch

__all__ = ["Canary"]

KERNELS = 1000
REPLAYS = 5


class Canary:
    """The captured chain on ``device`` (CUDA); :meth:`read` times it."""

    def __init__(self, device):
        self.device = torch.device(device)
        # the graph adds into this element's address on every replay: the
        # canary holds it, or the allocator hands the address to another
        # tensor that each reading would then corrupt
        self.x = x = torch.zeros(1, device=self.device)

        def run():
            for _ in range(KERNELS):
                x.add_(1.0)

        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            run()
        torch.cuda.synchronize(self.device)
        self.read()  # the first replay uploads the graph

    def read(self) -> float:
        """Microseconds per kernel over ``REPLAYS`` replays, by events."""
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(REPLAYS):
            self.graph.replay()
        t1.record()
        torch.cuda.synchronize(self.device)
        return 1e3 * t0.elapsed_time(t1) / (REPLAYS * KERNELS)
