"""The train event's LSTM backward against its roofline, in %: the least
time for the work of the backward calls, from their shapes, over the
device time of every kernel launched under the LSTM op's backward node
(autograd's thread, in the traced slots).

Work of one call over R = batch x users windows of T steps (the window
needs no gradient): operations T*R*(D+H)*4H*2 for dW and T*R*H*4H*2 for
the hidden state's cotangent (the gate products; recomputing the
forward is the implementation's choice, not counted); bytes the windows
and the cotangent read once, dW and db written.  Bound by the bf16 peak
(tensor cores) or the HBM bandwidth, whichever is longer."""


def ops(R, T, D, H):
    return T * R * (D + H) * 4 * H * 2 + T * R * H * 4 * H * 2


def bytes_moved(R, T, D, Dp, H):
    return 4 * (R * T * Dp + R * H + 2 * ((D + H) * 4 * H + 4 * H))


def read(ctx):
    if ctx.ranges is None or ctx.peaks is None:
        return None
    seconds, calls = ctx.ranges.backward_lstm_s()
    if calls == 0 or seconds <= 0:
        return None
    s = ctx.shapes
    R = s["batch"] * s["N"]
    bound = max(ops(R, s["T"], s["D"], s["H1"]) / ctx.peaks["bf16_flops"],
                bytes_moved(R, s["T"], s["D"], s["Dp"], s["H1"])
                / ctx.peaks["hbm_bytes"])
    return 100.0 * calls * bound / seconds
