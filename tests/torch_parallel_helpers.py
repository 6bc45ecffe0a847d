"""The rank processes of tests/test_torch_parallel.py.

    python tests/torch_parallel_helpers.py DIR RANK WORLD PORT

Each rank joins a gloo process group on localhost, blocks every import
of ``jax``, ``flax``, ``optax``, ``orbax`` and ``ttsx`` (the port must
run without them), reads ``DIR/inputs.pt`` (the cases the parent wrote:
weights as numpy trees, configs as dicts, batches, recorded draws), runs
every case named there in that order, then those of ``DIR/late.pt``
(written by the parent while the first ones run), and writes
``DIR/rank<RANK>.pt``: each case's result, or its traceback under
``"error"``, and each case's seconds. ``Group`` is the parent's side: it
writes the inputs, starts the ranks and returns a handle whose
``results()`` waits for them.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "ttsx"}


# ------------------------------------------------------------ parent side
class Group:
    """``world`` rank processes running the cases of ``inputs``."""

    def __init__(self, workdir: Path, inputs: dict, world: int = 2,
                 timeout: float = 300.0):
        import torch
        self.workdir, self.world, self.timeout = Path(workdir), world, timeout
        torch.save(inputs, self.workdir / "inputs.pt")
        from ttsx_torch.parallel.spawn import free_port
        port = free_port()
        env = {**os.environ, "PYTHONPATH": str(REPO),
               "OMP_NUM_THREADS": "1"}
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(self.workdir), str(r),
             str(world), str(port)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self._results = None

    def late(self, inputs: dict) -> None:
        """The cases the ranks run after the first ones (written whole,
        then renamed into place: the ranks wait for the name)."""
        import torch
        tmp = self.workdir / "late.tmp"
        torch.save(inputs, tmp)
        tmp.rename(self.workdir / "late.pt")

    def results(self):
        """Every rank's results, by rank; raises if a rank failed."""
        if self._results is None:
            import torch
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=self.timeout)[0])
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            rcs = [p.returncode for p in self.procs]
            if any(rcs):
                raise RuntimeError(f"rank processes exited {rcs}:\n"
                                   + "\n".join(l[-4000:] for l in logs))
            self._results = [
                torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]
        return self._results

    def case(self, name: str):
        """Case ``name``'s result on every rank; raises with a rank's
        traceback if it failed there."""
        out = [res[name] for res in self.results()]
        for r, o in enumerate(out):
            if isinstance(o, dict) and "error" in o:
                raise AssertionError(f"rank {r}, case {name}:\n{o['error']}")
        return out


# -------------------------------------------------------------- rank side
def _block_imports():
    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None
    sys.meta_path.insert(0, Block())


def _cfg(d):
    from ttsx_torch.core.config import TTSXConfig, from_dict
    return from_dict(TTSXConfig, d)


def _flat(tree):
    from ttsx_torch.train.checkpoint import flatten
    return {k: v.detach().clone() for k, v in flatten(tree).items()
            if v.is_floating_point()}


def _mesh(dp, tp):
    from ttsx_torch.core.config import MeshConfig
    from ttsx_torch.core.mesh import make_mesh
    return make_mesh(MeshConfig(dp=dp, tp=tp), device="cpu")


def case_mesh(inp):
    import torch
    from ttsx_torch.core.config import MeshConfig
    from ttsx_torch.core.mesh import make_mesh
    out = {}
    for dp, tp in ((-1, 1), (1, 2), (2, 1)):
        m = make_mesh(MeshConfig(dp=dp, tp=tp), device="cpu")
        out[(dp, tp)] = dict(shape=m.shape, dp_rank=m.dp_rank,
                             tp_rank=m.tp_rank,
                             gathered=m.all_gather(
                                 torch.tensor([m.rank]), "dp").tolist(),
                             tp_gathered=m.all_gather(
                                 torch.tensor([m.rank]), "tp").tolist(),
                             mean=m.mean({"x": float(m.rank)}))
    from ttsx_torch.parallel import make_dp_mesh
    out["dp_mesh"] = make_dp_mesh(device="cpu").shape
    for name, call in (("dp3_tp2", lambda: make_mesh(MeshConfig(dp=3, tp=2),
                                                     device="cpu")),
                       ("cuda_on_gloo", lambda: make_mesh(device="cuda")),
                       ("dp_mesh_of_3", lambda: make_dp_mesh(3, "cpu"))):
        try:
            call()
            out[name] = None
        except (ValueError, RuntimeError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def case_shard(inp):
    import numpy as np
    import torch
    from ttsx_torch.core.mesh import shard_batch
    from ttsx_torch.parallel import shard_batch_dp
    m = _mesh(2, 1)
    batch = {"x": torch.arange(16.0).reshape(8, 2),
             "ids": np.arange(8), "name": "bucket", "scalar": torch.tensor(3)}
    got = shard_batch_dp(batch, m)
    try:
        shard_batch({"x": torch.zeros(3, 2)}, m)
        odd = None
    except ValueError as e:
        odd = str(e)
    return {"x": got["x"], "ids": got["ids"], "name": got["name"],
            "scalar": got["scalar"], "odd": odd}


def _replay_step(block, batch, records, mesh, step):
    from ttsx_torch.core.mesh import shard_batch
    from ttsx_torch.nn.draws import ReplayDraws
    from ttsx_torch.train.blocks import as_tensors
    block.state.draws = ReplayDraws(records)
    with mesh:
        out = step(shard_batch(as_tensors(batch, "cpu"), mesh))
    metrics = mesh.mean({k: float(v) for k, v in out["metrics"].items()})
    return out, metrics, block.state.draws.exhausted()


def _mu(block):
    adamw = block.state.tx.adamw
    return {n: adamw.state[p]["exp_avg"].clone()
            for n, p in block.model.named_parameters()}


def case_acoustic(inp):
    from ttsx_torch.train.blocks import AcousticBlock
    from ttsx_torch.weights import load_flax
    m = _mesh(2, 1)
    block = AcousticBlock(_cfg(inp["cfg"]), "cpu", 0)
    load_flax(block.model, inp["tree"])
    out, metrics, done = _replay_step(block, inp["batch"], inp["records"], m,
                                      block.train_step)
    return {"metrics": metrics, "exhausted": done, "mu": _mu(block),
            "state": {k: v.clone() for k, v in
                      block.model.state_dict().items()},
            "mel_pred": m.all_gather(out["mel_pred"], "dp")}


def case_refiner(inp):
    import torch
    from ttsx_torch.core.mesh import dp_rows
    from ttsx_torch.models.refiner import sde_sample
    from ttsx_torch.parallel import dp_synthesis
    from ttsx_torch.train.blocks import RefinerBlock, as_tensors
    from ttsx_torch.weights import load_flax
    m = _mesh(2, 1)
    block = RefinerBlock(_cfg(inp["cfg"]), "cpu", 1)
    load_flax(block.model, inp["tree"])
    mel_pred = torch.as_tensor(inp["mel_pred"])
    out, metrics, done = _replay_step(
        block, inp["batch"], inp["records"], m,
        lambda b: block.train_step(b, dp_rows(mel_pred, m), 0.5, 0.7))
    b = as_tensors(inp["batch"], "cpu")
    args = (mel_pred, b["prosody"], b["style_id"], b["text_emb"])
    model = block.model.eval()
    with torch.no_grad(), m:
        # the reference's draws, this rank's rows of each
        sde = m.all_gather(sde_sample(
            model, *(dp_rows(a, m) for a in args),
            noise=[dp_rows(torch.as_tensor(n), m) for n in inp["noise"]]),
            "dp")
    # the port's own draws from a seeded generator, through dp_synthesis
    sde_gen = dp_synthesis(lambda *a: sde_sample(
        model, *a, generator=torch.Generator().manual_seed(11)), m)
    with torch.no_grad():
        own = sde_gen(*args)
    return {"metrics": metrics, "exhausted": done, "mu": _mu(block),
            "state": {k: v.clone() for k, v in
                      block.model.state_dict().items()},
            "sde": sde, "sde_own": own}


def case_band_tp(inp):
    import dataclasses
    import torch
    from ttsx_torch.core.config import VocoderConfig, from_dict
    from ttsx_torch.models.vocoder import Generator
    from ttsx_torch.weights import load_flax
    m = _mesh(1, 2)
    vc = dataclasses.replace(from_dict(VocoderConfig, inp["vocoder"]),
                             band_tp=True)
    gen = load_flax(Generator(vc), inp["tree"]).eval()
    x = [torch.as_tensor(inp[k]) for k in ("mel", "pros", "style", "emo")]
    tower = gen.band_tower
    rows = []
    tower.register_forward_hook(lambda mod, a, o: rows.append(a[0].shape[0]))
    with torch.no_grad(), m:
        wav = gen(*x)
    try:
        with torch.no_grad(), m:
            Generator(dataclasses.replace(vc, num_bands=5))(
                torch.zeros(1, 2, 80), *(a[:1, :2] if a.ndim == 3 else a[:1]
                                         for a in x[1:]))
        odd = None
    except ValueError as e:
        odd = str(e)
    return {"wav": wav, "tower_rows": rows, "odd": odd}


def _gan(cfg, batch, mesh):
    import contextlib
    from ttsx_torch.train.blocks import VocoderBlock
    block = VocoderBlock(cfg, "cpu", 0)
    with mesh or contextlib.nullcontext():
        d = block.disc_step(batch)
        g = block.gen_step(batch)
    return {"d": {k: float(v) for k, v in d.items()},
            "g": {k: float(v) for k, v in g.items()},
            "state": _flat(block.state_dict())}


def case_gan_band_tp(inp):
    """The step at dp = 1 x tp = 2, and the same step in this process
    without a mesh."""
    cfg = _cfg(inp["cfg"])
    return {"tp2": _gan(cfg, inp["batch"], _mesh(1, 2)),
            "one": _gan(cfg, inp["batch"], None)}


def case_server(inp):
    from ttsx_torch.models.pipeline import TTSPipeline
    from ttsx_torch.serve import SynthesisRequest, SynthesisServer
    from ttsx_torch.weights import load_flax
    m = _mesh(2, 1)
    pipe = TTSPipeline(_cfg(inp["cfg"]))
    for k, tree in inp["params"].items():
        load_flax(getattr(pipe, k), tree)
    srv = SynthesisServer(pipe, device="cpu", bf16=False, mesh=m,
                          **inp["kw"])
    return {"wavs": srv.serve_batch([SynthesisRequest(*r)
                                     for r in inp["reqs"]])}


def _engine(cfg, inp, mesh):
    from ttsx_torch.data.synthetic import synthetic_stream
    from ttsx_torch.train.engine import UnifiedTrainer
    tr = UnifiedTrainer(cfg, synthetic_stream(cfg, *inp["stream"]),
                        device="cpu", mesh=mesh)
    metrics = [tr.train_step(b) for b in inp["batches"]]
    for x in metrics:
        x.pop("step_time_s")
    return {"metrics": metrics, "state": _flat(tr.block_states),
            "emas": (tr.state.d_loss_ema, tr.state.g_loss_ema)}


def case_engine(inp):
    """Two engine steps at dp = 2, and the same in this process without
    a mesh."""
    cfg = _cfg(inp["cfg"])
    return {"dp2": _engine(cfg, inp, _mesh(2, 1)),
            "one": _engine(cfg, inp, None)}


def case_oom(inp):
    """A GAN step that runs out of memory on every rank raises under the
    mesh, where one process skips it."""
    import torch
    from ttsx_torch.train.engine import UnifiedTrainer
    cfg = _cfg(inp["cfg"])
    tr = UnifiedTrainer(cfg, iter([]), device="cpu", blocks=("vocoder",),
                        mesh=_mesh(2, 1))

    def oom(batch):
        raise torch.OutOfMemoryError("out of memory on the card")

    tr.blocks["vocoder"].gen_step = oom
    try:
        tr.train_step(inp["batch"])
        return {"raised": None}
    except torch.OutOfMemoryError as e:
        return {"raised": str(e), "oom_count": tr.state.oom_count}


def case_dryrun(inp):
    from ttsx_torch.parallel.dryrun import dryrun_step
    return dryrun_step(_mesh(2, 1))


def run_cases(inputs, results):
    for name in inputs["cases"]:
        t0 = time.perf_counter()
        try:
            results[name] = globals()[f"case_{name}"](inputs.get(name))
        except Exception:
            results[name] = {"error": traceback.format_exc()}
        results["seconds"][name] = time.perf_counter() - t0


def main(argv):
    workdir, rank, world, port = (Path(argv[0]), int(argv[1]), int(argv[2]),
                                  int(argv[3]))
    _block_imports()
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    results = {"seconds": {}}
    try:
        run_cases(inputs, results)
        # the cases whose inputs the parent computes while these run
        late = workdir / "late.pt"
        while not late.exists():
            time.sleep(0.05)
        run_cases(torch.load(late, weights_only=False), results)
        results["blocked"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in BLOCKED)
    finally:
        dist.destroy_process_group()
    torch.save(results, workdir / f"rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
