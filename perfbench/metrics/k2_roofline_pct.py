"""K2 (a generator stage's FiLM residual blocks in one launch, the
``StackFilm`` kernel): the least time of its launches in the traced
stretch over their device time.

Per stage of a call, rows = bands x batch x T_i f_i output frames at C
channels, n blocks (one per dilation): each block's two k=3 convolutions,
C -> 2C and C -> C, take 2 x 3 x (2 + 1) C^2 = 18 C^2 FLOPs a row; bytes:
x read and y written once, the FiLM [batch, frames, 2 n C] at the mel
rate, and the n blocks' weights (9 C^2) and biases (3 C), in float32."""
from perfbench.peaks import least_s, share_pct
from perfbench.trace import kernel_time


def match(name: str) -> bool:
    return "StackFilm" in name


def stage_costs(vocoder: dict, batch: int, frames: int):
    out, ch, t = [], vocoder["hidden_dim"], frames
    n = len(vocoder["res_dilations"])
    for f in vocoder["upsample_factors"]:
        C = ch // 2
        rows = vocoder["num_bands"] * batch * t * f
        nbytes = 4 * (2 * rows * C + batch * frames * 2 * n * C
                      + n * (9 * C * C + 3 * C))
        out.append((rows * n * 18 * C * C, nbytes))
        ch, t = C, t * f
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
