"""K1 (the generator's ConvTranspose upsample, ``upsample_mma``): the
least time of its launches in the traced stretch over their device time.

Per stage i of a call, on the bands folded into the batch (rows = bands x
batch), input [rows, T_i, C_i], factor f_i, output [rows, T_i f_i,
C_i / 2]: each output value sums two taps over C_i inputs, 4 C_i FLOPs;
bytes: the input, the [2 f_i, C_i, C_i / 2] kernel and the bias read
once, the output written once, in float32. The least time is the larger
of the FLOPs over the TF32 peak and the bytes over HBM's rate."""
from perfbench.peaks import least_s, share_pct
from perfbench.trace import kernel_time


def match(name: str) -> bool:
    return "upsample_mma" in name


def stage_costs(vocoder: dict, batch: int, frames: int):
    """[(flops, bytes)] of each stage of one call."""
    out, ch, t = [], vocoder["hidden_dim"], frames
    rows = vocoder["num_bands"] * batch
    for f in vocoder["upsample_factors"]:
        cin, cout = ch, ch // 2
        n_out = rows * t * f
        nbytes = 4 * (rows * t * cin + 2 * f * cin * cout + cout
                      + n_out * cout)
        out.append((n_out * cout * 4 * cin, nbytes))
        ch, t = cout, t * f
    return out


def read(record):
    if record.get("kind") != "serve":
        return None
    measured, launches = kernel_time(record["trace"], match)
    if launches == 0:
        return None
    costs = stage_costs(record["vocoder"], record["batch"], record["frames"])
    calls = launches / len(costs)
    least = calls * sum(least_s(f, b) for f, b in costs)
    return share_pct(least, measured)
