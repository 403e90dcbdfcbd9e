"""serve_mfu: the model FLOPs of every prefill and decode token the traced
stretch processed (the benchmark's count: real tokens, the head only
where logits are taken), over the stretch's seconds, as a share of the
H100's bf16 peak."""
from harness import counts, peaks, serve_rows


def read(run):
    if run.trace is None:
        return None
    w = run.widths
    flops = 0.0
    for prog in serve_rows.stretch_programs(run):
        for tail, ctx in prog:
            flops += counts.forward_flops(w, tail, counts.causal_pairs(tail, ctx), 1)
    for ctx in serve_rows.stretch_decode_contexts(run):
        flops += counts.forward_flops(w, 1, ctx, 1)
    if flops <= 0:
        return None
    return 100.0 * flops / run.trace.span_s / peaks.BF16_FLOPS
