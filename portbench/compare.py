"""The comparison that decides ``correct``: the plain reference
(``portbench/reference``) run on what the timed path consumed, and the
numbers that measure how far the program's output lies from it.

With random weights (no trained checkpoint is in the repository) every
output past a threshold is chaotic: an attention-mask bit of the decoder
(mask logit < 0) or a Hungarian assignment that rounding tips over changes
the following layers, so the final masks, the label maps, the losses and
most gradients of two sound computations can part by as much as bf16
against float8 does.  The numbers are therefore read where no threshold
lies upstream, or over the steps and images as a whole.  Each cell's
workload file names the ones that decide ``correct``, with their limits
(``limits``); ``python3 -m portbench.control`` reads them all.

Train (``train_readings``; the program's first steps against the
reference's on the same batches):

* ``features``: the pixel decoder's output (the mask features: backbone,
  K1 and the deformable encoder, the FPN), relative Frobenius gap;
* ``first_masks``: the decoder's first mask prediction, rendered from the
  learnable queries over those features before any masked attention (K3
  in eval, its twin in training), relative Frobenius gap;
* ``loss``: each step's total loss, relative gap, the worst step; and each
  raw term of the loss under its own name (``loss_sem``, ``loss_mask``,
  ...), the same;
* ``grad_*`` and ``update_*``: leaf by leaf, the gap between the
  program's and the reference's norms of the first gradient as the
  optimizer got it (AdamW's first moment after one step over 1 - beta1)
  and of the parameters' change over the compared steps, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger; the worst leaf, the median, the 90th percentile and the
  global norm.  Leaves whose reference gradient norm is under a
  thousandth of the median leaf's are left out (their moves are
  round-off: a key's bias under softmax); a leaf one side moves and the
  other does not reads 1.

Eval (``eval_readings``; the sampled batches of the window against the
reference's protocol on the same images): ``features`` and
``first_masks`` of the first forward, as in training; ``peaks``, the
final masks' TOP_K peak logits (relative median gap, the worst image;
``peaks_median``); ``mask_area``, the sorted mask areas after TOP_K and
the re-run (a re-run decision that differs reads 1); ``labels``, the
share of instance pixels the best one-to-one matching of the label maps
leaves unmatched (the worst image; ``labels_median``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from .reference import criterion as ref_criterion
from .reference import postprocess as ref_post
from .reference.config import ModelConfig
from .reference.model import PCTransReference
from .reference.ops import resize_binarize_twin
from .reference.solver import SolverConfig, build_optimizer, set_lr
from .reference.targets import targets_from_labels

LEAF_FLOOR = 1e-3          # of the median leaf's reference gradient norm


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32 (the reference's), whatever the program set."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """An f32 copy on the host (``.cpu()`` of a host tensor is no copy)."""
    return t.detach().to("cpu", dtype=torch.float32, copy=True)


def model_config(config: dict) -> ModelConfig:
    return ModelConfig.from_sizes(config["model"])


def reference_model(config: dict, device, precision: str = "config") -> PCTransReference:
    """The reference with the configuration's weights (``weights_seed``),
    made on ``device`` by one generator there: the weights the harness
    gives the program."""
    gen = torch.Generator(device=device).manual_seed(int(config["weights_seed"]))
    with torch.device(device):
        return PCTransReference(model_config(config), generator=gen, precision=precision)


def seeded_state(config: dict, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights as a state dict on ``device``."""
    return reference_model(config, device).state_dict()


def snapshot(out: Dict) -> Dict[str, torch.Tensor]:
    """The forward's outputs upstream of every threshold, kept on their
    device: the mask features and the first mask prediction."""
    return {"features": out["mask_features"].detach().float().clone(),
            "first_masks": out["aux_masks"][0].detach().float().clone()}


def to_host(snap: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: host_copy(v) for k, v in snap.items()}


def rel_fro(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| (Frobenius); a shape that differs reads 1."""
    if a.shape != b.shape:
        return 1.0
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-300))


@dataclasses.dataclass
class TrainOutput:
    """What a train path produced in its first steps."""
    losses: List[float]                       # total loss per step
    grads: Dict[str, torch.Tensor]            # first step's gradient per leaf (host f32)
    params: Dict[str, torch.Tensor]           # parameters after the steps (host f32)
    snap: Dict[str, torch.Tensor]             # the first step's forward (host f32)
    terms: List[Dict[str, float]]             # the loss's raw terms per step
    initial: Optional[Dict[str, torch.Tensor]] = None     # before them (host f32)


def reference_train(config: dict, batches: Sequence[dict], device,
                    precision: str = "config", fault=None) -> TrainOutput:
    with no_tf32(), (fault.in_reference(train=True) if fault is not None
                     else contextlib.nullcontext()):
        return _reference_train(config, batches, device, precision, fault)


def _reference_train(config, batches, device, precision, fault) -> TrainOutput:
    """The reference's first ``len(batches)`` steps from the configuration's
    weights: the criterion's draws from a generator seeded as the program's
    (``train.draw_seed``), AdamW at WarmupPolyLR's rate of each step.
    ``fault`` (``faults.py``) plants a fault in it, for its readings."""
    model = reference_model(config, device, precision)
    initial = {n: host_copy(p) for n, p in model.named_parameters()}
    crit = ref_criterion.SetCriterion(ref_criterion.CriterionConfig(**config["criterion"]))
    solver = SolverConfig.from_sizes(config["solver"])
    opt = build_optimizer(model, solver)
    gen = torch.Generator(device=device).manual_seed(int(config["train"]["draw_seed"]))
    G = int(config["train"]["max_instances"])
    Q = model.config.num_queries
    losses, terms, grads = [], [], {}
    model.train()
    for step, batch in enumerate(batches):
        images = torch.as_tensor(batch["image"]).to(device).float()
        labels = torch.as_tensor(batch["label"]).to(device).int()
        targets = targets_from_labels(labels, G)
        reid, drawn = crit.draws(images.shape[0], G, Q, gen, device)
        set_lr(opt, step, solver)
        opt.zero_grad(set_to_none=True)
        out = model(images)
        if step == 0:
            snap = to_host(snapshot(out))
        total, raw, _ = crit(out, targets, reid, drawn or None)
        total.backward()
        if step == 0:
            grads = {n: host_copy(p.grad) for n, p in model.named_parameters()
                     if p.grad is not None}
        if fault is None or not fault.unchanged:
            opt.step()
        losses.append(float(total.detach()))
        terms.append({k: float(v.detach()) for k, v in raw.items()})
    params = {n: host_copy(p) for n, p in model.named_parameters()}
    return TrainOutput(losses, grads, params, snap, terms, initial)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Per leaf: the gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger; a leaf the program lacks reads 1."""
    norms = {n: float(ref[n].double().norm()) for n in leaves}
    median = float(np.median(list(norms.values()))) if norms else 0.0
    return {n: (abs(float(prog[n].double().norm()) - norms[n]) / max(norms[n], median, 1e-30)
                if n in prog else 1.0) for n in leaves}


def _summary(name: str, gaps: Dict[str, float], prog, ref, leaves) -> Dict[str, float]:
    values = np.array(list(gaps.values()) or [0.0])
    p_norm = math.sqrt(sum(float(prog[n].double().norm()) ** 2 for n in leaves if n in prog))
    r_norm = math.sqrt(sum(float(ref[n].double().norm()) ** 2 for n in leaves))
    return {f"{name}_worst": float(values.max()),
            f"{name}_median": float(np.median(values)),
            f"{name}_p90": float(np.quantile(values, 0.9)),
            f"{name}_global": abs(p_norm - r_norm) / max(r_norm, 1e-30)}


def _gaps(prog: Sequence[float], ref: Sequence[float]) -> List[float]:
    """Step by step, |program - reference| / |reference| (a step the
    program has no finite value for reads infinite)."""
    return [abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf
            for a, b in zip(prog, ref)]


def train_readings(prog: TrainOutput, ref: TrainOutput, detail: bool = False
                   ) -> Dict[str, object]:
    """The numbers, program against reference (both from the reference's
    initial weights, which the program was given); with ``detail``, the
    five worst leaves of each."""
    initial = ref.initial
    loss = max(_gaps(prog.losses, ref.losses))
    # each raw term of the loss, its worst step
    terms = {k: max(_gaps([t.get(k, math.nan) for t in prog.terms],
                          [t[k] for t in ref.terms]))
             for k in (ref.terms[0] if ref.terms else {})}
    gnorms = {n: float(g.double().norm()) for n, g in ref.grads.items()}
    median = float(np.median(list(gnorms.values())))
    leaves = [n for n, v in gnorms.items() if v >= LEAF_FLOOR * median]
    extra = [n for n in prog.grads if n not in ref.grads]
    g_gaps = leaf_gaps(prog.grads, ref.grads, leaves)
    if extra:                               # a leaf the reference does not move
        g_gaps.update({n: 1.0 for n in extra})
    d_prog = {n: prog.params[n] - initial[n] for n in leaves if n in prog.params}
    d_ref = {n: ref.params[n] - initial[n] for n in leaves}
    u_gaps = leaf_gaps(d_prog, d_ref, leaves)
    out = {"features": rel_fro(prog.snap["features"], ref.snap["features"]),
           "first_masks": rel_fro(prog.snap["first_masks"], ref.snap["first_masks"]),
           "loss": loss, **terms, **_summary("grad", g_gaps, prog.grads, ref.grads, leaves),
           **_summary("update", u_gaps, d_prog, d_ref, leaves)}
    if detail:
        out["detail"] = {
            "leaves": len(leaves), "left_out": len(gnorms) - len(leaves),
            "grad": sorted(((round(v, 4), n) for n, v in g_gaps.items()), reverse=True)[:5],
            "update": sorted(((round(v, 4), n) for n, v in u_gaps.items()), reverse=True)[:5],
            "losses": [[a, b] for a, b in zip(prog.losses, ref.losses)],
            "terms": [[a, b] for a, b in zip(prog.terms, ref.terms)]}
    return out


# --------------------------------------------------------------------- eval
@dataclasses.dataclass
class EvalOutput:
    """A labelled batch: the first forward's snapshot (host f32) and TOP_K
    peak logits (highest first), the masks' areas after the TOP_K filter
    and the re-run, and the int16 label maps."""
    snap: Dict[str, torch.Tensor]
    peaks: np.ndarray          # [B, TOP_K]
    areas: np.ndarray          # [B, K]
    labels: np.ndarray         # [B, H, W]


def reference_eval(model: PCTransReference, images: np.ndarray, top_k: Optional[int],
                   threshold: float, dataset: str, fault=None) -> EvalOutput:
    """The eval protocol on the reference: masks at the input size, TOP_K's
    filter and its lossiness check (a lossy batch runs again with all
    queries), then the numpy postprocess.  ``fault`` breaks the mask
    logits, for the readings of a fault."""
    with no_tf32(), (fault.in_reference(train=False) if fault is not None
                     else contextlib.nullcontext()):
        return _reference_eval(model, images, top_k, threshold, dataset, fault)


def _reference_eval(model, images, top_k, threshold, dataset, fault) -> EvalOutput:
    device = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
    logit_t = math.log(threshold / (1.0 - threshold))
    model.eval()
    with torch.no_grad():
        out = model(fault.images(x) if fault is not None else x)
        snap = to_host(snapshot(out))
        logits = out["pred_masks"].float()
        peak = logits.amax(dim=(2, 3))
        masks = None
        peaks = peak
        if top_k is not None and top_k < logits.shape[1]:
            peaks, idx = torch.topk(peak, top_k, dim=1)
            if not bool((torch.sigmoid(peaks[:, -1]) > threshold).any()):
                kept = torch.take_along_dim(logits, idx[:, :, None, None], dim=1)
                masks = resize_binarize_twin(kept, tuple(x.shape[1:3]), logit_t)
        if masks is None:
            masks = resize_binarize_twin(logits, tuple(x.shape[1:3]), logit_t)
        areas = masks.float().sum(dim=(2, 3)).cpu().numpy()
        host = masks.cpu().numpy()
        peaks = peaks.cpu().numpy()
    infer = (ref_post.instance_inference_bbbc if dataset == "bbbc"
             else ref_post.instance_inference_cvppp)
    labels = np.stack([infer(m.astype(np.float32), threshold) for m in host])
    return EvalOutput(snap, peaks, areas, labels)


def label_disagreement(a: np.ndarray, b: np.ndarray) -> float:
    """Share of the pixels in an instance of either map that the best
    one-to-one matching of the two maps' ids leaves unmatched."""
    a = a.astype(np.int64).ravel()
    b = b.astype(np.int64).ravel()
    fg = (a > 0) | (b > 0)
    total = int(fg.sum())
    if total == 0:
        return 0.0
    a, b = a[fg], b[fg]
    ia, a_idx = np.unique(a, return_inverse=True)
    ib, b_idx = np.unique(b, return_inverse=True)
    overlap = np.zeros((len(ia), len(ib)), np.int64)
    np.add.at(overlap, (a_idx, b_idx), 1)
    # background matches background only
    overlap[ia == 0, :] = 0
    overlap[:, ib == 0] = 0
    rows, cols = linear_sum_assignment(-overlap)
    return 1.0 - float(overlap[rows, cols].sum()) / total


def peak_gaps(prog: Sequence[EvalOutput], ref: Sequence[EvalOutput]) -> List[float]:
    """Per image: the median over its TOP_K peaks of |program - reference|,
    over the median |reference|."""
    out = []
    for p, r in zip(prog, ref):
        for pp, rp in zip(p.peaks, r.peaks):
            out.append(float(np.median(np.abs(pp.astype(np.float64) - rp)))
                       / max(float(np.median(np.abs(rp))), 1e-30))
    return out


def eval_readings(prog: Sequence[EvalOutput], ref: Sequence[EvalOutput]) -> Dict[str, float]:
    """The eval numbers: ``features`` and ``first_masks``, the largest gap
    over the batches; the final masks' peaks (``peaks``, the largest
    per-image gap of :func:`peak_gaps`), their sorted areas (``mask_area``,
    largest per batch; a re-run decision that differs reads 1) and the
    label maps (``labels``, largest per image; ``labels_median``)."""
    area, labels = 0.0, []
    for p, r in zip(prog, ref):
        if p.areas.shape != r.areas.shape:
            area = max(area, 1.0)
        else:
            pa, ra = np.sort(p.areas, axis=1), np.sort(r.areas, axis=1)
            area = max(area, float(np.abs(pa - ra).sum()) / max(float(ra.sum()), 1.0))
        labels += [label_disagreement(lp, lr) for lp, lr in zip(p.labels, r.labels)]
    gaps = peak_gaps(prog, ref)
    snaps = {k: max(rel_fro(p.snap[k], r.snap[k]) for p, r in zip(prog, ref))
             for k in ("features", "first_masks")}
    return {**snaps, "peaks": max(gaps), "peaks_median": float(np.median(gaps)), "mask_area": area,
            "labels": max(labels), "labels_median": float(np.median(labels))}


def eval_details(prog: Sequence[EvalOutput], ref: Sequence[EvalOutput]) -> Dict[str, list]:
    """Per image: the peak gap, the label disagreement and the sorted
    areas' relative L1 gap; per batch: the number of masks on each side."""
    labels, areas, ks = [], [], []
    for p, r in zip(prog, ref):
        ks.append([int(p.areas.shape[1]), int(r.areas.shape[1])])
        for b, (lp, lr) in enumerate(zip(p.labels, r.labels)):
            labels.append(round(label_disagreement(lp, lr), 6))
            if p.areas.shape == r.areas.shape:
                pa, ra = np.sort(p.areas[b]), np.sort(r.areas[b])
                areas.append(round(float(np.abs(pa - ra).sum()) / max(float(ra.sum()), 1.0), 6))
    return {"peaks": [round(g, 6) for g in peak_gaps(prog, ref)], "labels": labels,
            "areas": areas, "masks": ks,
            "peak_scale": [round(float(np.median(np.abs(r.peaks))), 3) for r in ref]}


def sample(n: int, k: int, seed: int) -> List[int]:
    """``k`` of ``range(n)`` drawn from ``seed``, sorted."""
    rng = np.random.RandomState((int(seed) + 1) % (2 ** 32))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
