"""Train-state checkpoints (``ttsx/train/checkpoint.py``), without orbax.

The layout is the reference's: one directory per tag (``best``, ``last``,
``final``) under the checkpoint directory, holding ``meta.json`` with
the reference's keys (``step``, ``extra``) and the state. The state is a
nested dict of tensors (the blocks' ``state_dict``: parameters and
buffers, optimizer moments and counts, EMAs, generator states) stored
flat, keys joined by ``/``, as one ``torch.save`` file (``state.pt``,
tensors on the CPU) that ``restore_checkpoint`` reads back with
``torch.load(..., weights_only=True)``.

A tag is complete once its ``meta.json`` exists: ``save_checkpoint``
removes it first and writes it last, each file replaced atomically, so
a save cut short leaves a tag that restores as absent. Restoring checks
every key, shape and dtype against a template of the same structure and
raises ``CheckpointMismatch`` naming what differs; nothing loads in part.
A ``torch.Generator``'s state is its device's (a CUDA generator's is not
a CPU one's), so a train state restores on the kind of device that saved
it; ``load_pipeline_checkpoint`` takes the parameters alone and loads
anywhere.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import torch

STATE_FILE = "state.pt"
META_FILE = "meta.json"


class CheckpointMismatch(KeyError):
    """A checkpoint's keys, shapes or dtypes differ from the template's."""


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(flat: Mapping[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _write(path: Path, write) -> None:
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(directory: str, tag: str, block_states: Mapping,
                    step: int, extra: Optional[Dict] = None) -> None:
    """Write ``block_states`` (nested dicts of tensors) under
    ``directory/tag`` with ``meta.json`` = {"step", "extra"}."""
    path = Path(directory).absolute() / tag
    path.mkdir(parents=True, exist_ok=True)
    (path / META_FILE).unlink(missing_ok=True)
    flat = {k: v.detach().cpu() for k, v in flatten(block_states).items()}
    _write(path / STATE_FILE, lambda p: torch.save(flat, p))
    meta = json.dumps({"step": int(step), "extra": extra or {}})
    _write(path / META_FILE, lambda p: p.write_text(meta))


def read_meta(directory: str, tag: str) -> Optional[Dict]:
    """``meta.json`` ({"step", "extra"}) of ``directory/tag`` without its
    state, or None when the tag is absent."""
    path = Path(directory).absolute() / tag / META_FILE
    return json.loads(path.read_text()) if path.exists() else None


def read_checkpoint(directory: str, tag: str
                    ) -> Optional[Tuple[Dict[str, torch.Tensor], int, Dict]]:
    """(flat state on the CPU, step, extra) of ``directory/tag``, or None
    when the tag is absent."""
    path = Path(directory).absolute() / tag
    if not (path / META_FILE).exists():
        return None
    meta = json.loads((path / META_FILE).read_text())
    flat = torch.load(path / STATE_FILE, map_location="cpu",
                      weights_only=True)
    return flat, meta["step"], meta.get("extra", {})


def check_like(flat: Mapping[str, torch.Tensor],
               want: Mapping[str, torch.Tensor], what: str) -> None:
    """Raise ``CheckpointMismatch`` unless ``flat`` has exactly ``want``'s
    keys, each with its shape and dtype."""
    missing = sorted(set(want) - set(flat))
    unexpected = sorted(set(flat) - set(want))
    wrong = [f"{k}: {tuple(flat[k].shape)} {flat[k].dtype}, want "
             f"{tuple(want[k].shape)} {want[k].dtype}"
             for k in sorted(set(want) & set(flat))
             if (flat[k].shape != want[k].shape
                 or flat[k].dtype != want[k].dtype)]
    if missing or unexpected or wrong:
        raise CheckpointMismatch(
            f"{what}: missing {missing}; unexpected {unexpected}; "
            f"shape or dtype differs {wrong}")


def restore_checkpoint(directory: str, tag: str, template_states: Mapping
                       ) -> Optional[Tuple[Dict, int, Dict]]:
    """(states, step, extra) with ``states`` shaped like
    ``template_states``, each tensor on its template's device; None when
    the tag is absent. Raises ``CheckpointMismatch`` on any key, shape or
    dtype that differs."""
    got = read_checkpoint(directory, tag)
    if got is None:
        return None
    flat, step, extra = got
    want = flatten(template_states)
    check_like(flat, want, f"checkpoint {Path(directory) / tag}")
    return (_unflatten({k: v.to(want[k].device) for k, v in flat.items()}),
            step, extra)


def load_pipeline_checkpoint(pipe: torch.nn.Module, directory: str,
                             tag: str = "best") -> Dict:
    """Fill the pipeline's stages from an engine checkpoint: ``acoustic``
    and ``refiner`` from their blocks' parameters and buffers,
    ``generator`` from the vocoder block's generator with its EMA in
    place of the parameters (the reference's ``eval_params``) and ``gst``
    from its GST; each stage whole, checked like ``restore_checkpoint``.
    Stages the run did not train keep what they hold. Returns {"tag",
    "step", "stages"}; raises ``FileNotFoundError`` when the tag is
    absent."""
    got = read_checkpoint(directory, tag)
    if got is None:
        raise FileNotFoundError(f"no checkpoint '{tag}' under {directory}")
    flat, step, _ = got
    tree = _unflatten(flat)
    states = {stage: flatten(tree[stage]["params"])
              for stage in ("acoustic", "refiner") if stage in tree}
    if "vocoder" in tree:
        gen = tree["vocoder"]["gen"]
        states["generator"] = {**flatten(gen["params"]),
                               **flatten(gen.get("ema", {}))}
        states["gst"] = flatten(tree["vocoder"]["gst"]["params"])
    if not states:
        raise CheckpointMismatch(f"checkpoint {Path(directory) / tag} holds "
                                 f"no synthesis stage")
    for stage, state in states.items():
        module = getattr(pipe, stage)
        check_like(state, module.state_dict(), f"{tag}: {stage}")
        module.load_state_dict(state, strict=True)
    return {"tag": tag, "step": step, "stages": sorted(states)}
