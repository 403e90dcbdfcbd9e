"""train_mfu: the model FLOPs of a training step (the benchmark's count
from the configuration's widths: forward and backward, no recompute) x
the window's untraced steps, over their seconds, as a share of the
H100's bf16 peak."""
from harness import counts, peaks


def read(run):
    if run.kind != "train" or run.steps_untraced == 0:
        return None
    mix = run.cell.traffic
    flops = counts.train_step_flops(run.widths, mix["batch"], mix["seq"])
    return 100.0 * flops * run.steps_untraced / run.window_untraced_s / peaks.BF16_FLOPS
