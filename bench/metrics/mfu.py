"""Model FLOPs of every token the window's prefills and decode steps
processed, over the window's length at the H100's dense bf16 peak; in %."""
from bench.counts import BF16_PEAK, window_flops


def read(run):
    cap = run.capture
    if not run.window_s or not (cap.prefill_lens or cap.decode_ctx):
        return None
    f = window_flops(run.hf, cap.prefill_lens, cap.decode_ctx)
    return 100.0 * f / (run.window_s * BF16_PEAK)
