"""The whole training step's share of the card's bf16 peak, in %: model
FLOPs a slot times the window's slots a second (over the chunks that
end after the profiled slots, which the profilers do not slow).

Model FLOPs a slot (2 a multiply-add, the Q-net's products only): the
acting forward over every agent of every env, plus one train event's
over its episode's slots.  A train event makes ``n_batch`` gradient
steps over batch x users windows, each counted as 5 forwards: the
forward and its backward (2) on the states, the online and the target
forward on the next states.  One forward of one window: the LSTM's
T*(D+H)*4H*2, then H1*H2*2 and H2*C*2."""


def per_window(T, D, H1, H2, C):
    return T * (D + H1) * 4 * H1 * 2 + H1 * H2 * 2 + H2 * C * 2


def flops_per_slot(s):
    f = per_window(s["T"], s["D"], s["H1"], s["H2"], s["C"])
    act = s["B_global"] * s["N"] * f
    event = s["n_batch"] * 5 * s["batch"] * s["N"] * f
    return act + event / s["interval"]


def read(ctx):
    if ctx.peaks is None or ctx.slots == 0:
        return None
    # slots a second over the chunks after the profiles, where there are
    slots, seconds = ctx.after_trace or (ctx.slots, ctx.wall_s)
    rate = slots / seconds
    return 100.0 * flops_per_slot(ctx.shapes) * rate / ctx.peaks["bf16_flops"]
