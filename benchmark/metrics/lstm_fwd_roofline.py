"""The acting forward's LSTM against its roofline, in %: the least time
the card could take for the call's work, from the call's shapes, over
the device time of every kernel that the call launched (the profiler's
``bench.lstm_fwd`` range around the Q-net's LSTM, in the traced slots).

Work of one call over R = envs x users windows of T steps: operations
R*T*(D+H)*4H*2 (the gate products; the algorithm needs no more), bytes
the window read once (R*T*Dp float32 lanes), the weights and bias, and
the last hidden state written (R*H float32).  The products run on the
tensor cores (bf16 operands, float32 sums), so the bound is the bf16
peak or the HBM bandwidth, whichever is longer."""


def ops(R, T, D, H):
    return R * T * (D + H) * 4 * H * 2


def bytes_moved(R, T, D, Dp, H):
    return 4 * (R * T * Dp + (D + H) * 4 * H + 4 * H + R * H)


def read(ctx):
    if ctx.ranges is None or ctx.peaks is None:
        return None
    seconds, calls = ctx.ranges.range_device_s("bench.lstm_fwd")
    if calls == 0 or seconds <= 0:
        return None
    s = ctx.shapes
    R = s["B"] * s["N"]
    bound = max(ops(R, s["T"], s["D"], s["H1"]) / ctx.peaks["bf16_flops"],
                bytes_moved(R, s["T"], s["D"], s["Dp"], s["H1"])
                / ctx.peaks["hbm_bytes"])
    return 100.0 * calls * bound / seconds
