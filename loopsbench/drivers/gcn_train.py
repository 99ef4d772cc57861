"""Full-graph GCN training, as OGB's arxiv example runs it: each epoch is
one training step and one evaluation on the validation rows, and the
host reads the loss and then the accuracy, epoch after epoch.

The program: ``loops_tpu_torch.models`` ``Graph.from_edges``, ``GCN``
(``schedule="auto"``: K4 forward and backward on an H100), ``train.
make_train_step`` with ``torch.optim.Adam``, and ``train.evaluate``.
Set-up builds that one step, drives it through its first epochs (the
ones the reference follows), and hands the same objects to the window.

The check follows those first steps with ``reference/gcn.py`` and reads
each step's loss, each epoch's validation accuracy as ``evaluate``
gave it, each leaf's first gradient as Adam got it (its first moment
after one step over ``1 - beta1``), and each leaf's change over the
steps; each norm as the gap between the program's norm and the
reference's over the larger of the reference's norm of that leaf and of
the median leaf. A leaf whose reference gradient is under a thousandth
of the median leaf's is left out. The traffic file's ``limits`` name the
numbers compared.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import math
import statistics
import time
from unittest import mock

import torch

from loopsbench import counters
from loopsbench.harness import sub_seed
from loopsbench.reference import gcn as reference

# a leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by round-off alone, and is not compared
TINY_GRADIENT = 1e-3


def dims_of(cfg: dict) -> list:
    g = cfg["graph"]
    return ([int(g["num_features"])]
            + [int(cfg["hidden_channels"])] * (int(cfg["num_layers"]) - 1)
            + [int(g["num_classes"])])


def make_inputs(cell, seed: int, device) -> tuple[dict, dict]:
    """The data set and the initial weights (Glorot-uniform, zero
    biases), both on ``device`` and from the seed."""
    cfg = cell.config
    gen = importlib.import_module(
        f"loopsbench.gen.{cfg['graph']['generator']}")
    data = gen.make(cfg["graph"], seed, device)
    dims = dims_of(cfg)
    sizes = [dims[i] * dims[i + 1] for i in range(len(dims) - 1)]
    u = torch.rand(sum(sizes), generator=torch.Generator(device).manual_seed(
        sub_seed(seed, "weights")), device=device)
    init, start = {}, 0
    for i, size in enumerate(sizes):
        lim = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
        w = u[start:start + size].view(dims[i], dims[i + 1])
        init[f"layers.{i}.w"] = w * (2 * lim) - lim
        init[f"layers.{i}.b"] = torch.zeros(dims[i + 1], device=device)
        start += size
    return data, init


def epoch_work(n: int, nnz: int, dims: list):
    """One epoch's K4 launches (the train step's forward and backward,
    and the evaluation's forward), and its flops counted from shapes."""
    out = dims[1:]
    widths = out + out[::-1] + out
    spmm = [counters.csr_spmm_work(n, n, nnz, f) for f in widths]
    pairs = list(zip(dims[:-1], dims[1:]))
    fwd = sum(counters.dense_matmul_flops(n, a, b) for a, b in pairs)
    # the backward: each weight's gradient, and each layer's input
    # gradient but the first's
    bwd = fwd + sum(counters.dense_matmul_flops(n, a, b)
                    for a, b in pairs[1:])
    flops = 2 * fwd + bwd + sum(w.flops for w in spmm)
    return spmm, flops


class State:
    pass


def setup(run, cell, seed: int, device) -> State:
    t0 = time.perf_counter()
    from loops_tpu_torch.models import GCN, Graph, train
    from loops_tpu_torch.models.gcn import load_params
    run.setup_parts["imports"] = time.perf_counter() - t0

    cfg, traffic = cell.config, cell.traffic
    st = State()
    with run.phase("inputs"):
        data, init = make_inputs(cell, seed, device)
        dims = dims_of(cfg)
        n = data["num_nodes"]
        # the reference's inputs, on the host: nothing the program can
        # touch
        st.ref_data = {k: (v.cpu().clone() if torch.is_tensor(v) else v)
                       for k, v in data.items()}
        st.init = {k: v.cpu().clone() for k, v in init.items()}
        nnz = reference.gcn_adjacency(data["src"], data["dst"], n)[0].numel()
        spmm, run.unit_flops = epoch_work(n, nnz, dims)
        run.unit_work = {"flat_spmm": spmm}

    src, dst = data["src"].cpu().numpy(), data["dst"].cpu().numpy()
    t0 = time.perf_counter()
    graph = Graph.from_edges(src, dst, n, make_undirected=True)
    model = GCN(graph, dims, dropout=float(cfg["dropout"]), schedule="auto",
                device=device)
    run.plan_s = run.setup_parts["plan"] = time.perf_counter() - t0
    with run.phase("step"):
        load_params(model.layers, [
            {"w": init[f"layers.{i}.w"], "b": init[f"layers.{i}.b"]}
            for i in range(len(dims) - 1)])
        opt = torch.optim.Adam(model.parameters(), lr=float(cfg["lr"]),
                               betas=tuple(cfg["betas"]),
                               eps=float(cfg["eps"]))
        st.dropout_seed = sub_seed(seed, "dropout")
        st.step = train.make_train_step(
            model, opt, data["features"], data["labels"], data["train_mask"],
            generator=torch.Generator(device).manual_seed(st.dropout_seed))
        st.evaluate = train.evaluate
        st.model, st.opt = model, opt
        st.features, st.labels = data["features"], data["labels"]
        st.val_mask = data["val_mask"]
        del data

    steps = int(traffic["compare_steps"])
    names = dict((id(p), k) for k, p in model.named_parameters())
    st.losses, st.accs, st.grad_norms = [], [], {}
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    for k in range(1, steps + 1):
        with run.phase(f"unit {k}"):
            unit(run, st)
        st.losses.append(st.last_loss)
        st.accs.append(st.last_acc)
        if k == 1:
            b1 = float(cfg["betas"][0])
            st.grad_norms = {
                names[id(p)]: float(s["exp_avg"].norm()) / (1.0 - b1)
                for p, s in opt.state.items() if "exp_avg" in s}
    st.change_norms = {k: float((p.detach() - start[k]).norm())
                       for k, p in model.named_parameters()}
    del start
    with run.phase("warm"):
        for _ in range(int(traffic["warm_units"])):
            unit(run, st)
    return st


def unit(run, st) -> bool:
    with run.span("epoch.train"):
        loss = st.step()
    with run.span("host.read"):
        st.last_loss = loss.item()
    with run.span("epoch.eval"):
        st.last_acc = st.evaluate(st.model, st.features, st.labels,
                                  st.val_mask)
    return math.isfinite(st.last_loss) and math.isfinite(st.last_acc)


def leaf_gaps(got: dict, want: dict, leaves) -> dict:
    """Each leaf's gap between ``got``'s and ``want``'s norm of it, over
    the larger of ``want``'s norm of that leaf and of the median leaf;
    inf where ``got`` lacks the leaf."""
    med = statistics.median(want[k] for k in leaves)
    return {k: (abs(got[k] - want[k]) / max(want[k], med)
                if k in got and math.isfinite(got[k]) else math.inf)
            for k in leaves}


def compare(got: dict, ref: dict) -> dict:
    """``{name: value}`` of every number the check can compare: each
    step's loss gap and their largest, the largest gap of an epoch's
    validation accuracy (a share of the rows), the worst and the median
    leaf's gap of the first gradient and of the change, and each
    leaf's."""
    med = statistics.median(ref["grad_norms"].values())
    leaves = [k for k, v in ref["grad_norms"].items()
              if v >= TINY_GRADIENT * med]
    losses = got["losses"]
    if len(losses) == len(ref["losses"]) and all(map(math.isfinite, losses)):
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    else:
        gaps = [math.inf] * len(ref["losses"])
    out = dict(loss_gap=max(gaps),
               **{f"loss{i}_gap": g for i, g in enumerate(gaps, 1)})
    accs = got["accs"]
    out["acc_gap"] = (max(abs(a - b) for a, b in zip(accs, ref["accs"]))
                      if len(accs) == len(ref["accs"])
                      and all(map(math.isfinite, accs)) else math.inf)
    for name in ("grad", "change"):
        per = leaf_gaps(got[f"{name}_norms"], ref[f"{name}_norms"], leaves)
        out[f"{name}_gap"] = max(per.values())
        out[f"{name}_median_gap"] = statistics.median(per.values())
        out.update({f"{name}_gap.{k}": v for k, v in per.items()})
    return out


def _free(st) -> None:
    for k in ("step", "model", "opt", "features", "labels", "val_mask"):
        setattr(st, k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _reference(cell, st, device, **kw) -> dict:
    data = {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in st.ref_data.items()}
    return reference.train(data, st.init, cell.config, st.dropout_seed,
                           int(cell.traffic["compare_steps"]), **kw)


def check(run, st) -> dict:
    _free(st)
    ref = _reference(run.cell, st, run.device)
    got = dict(losses=st.losses, accs=st.accs, grad_norms=st.grad_norms,
               change_norms=st.change_norms)
    return compare(got, ref)


def control(cell, seed: int, device) -> dict:
    """The reference in float32 with TF32 on, in the program's place."""
    st = State()
    data, init = make_inputs(cell, seed, device)
    st.ref_data = {k: (v.cpu() if torch.is_tensor(v) else v)
                   for k, v in data.items()}
    st.init = {k: v.cpu() for k, v in init.items()}
    st.dropout_seed = sub_seed(seed, "dropout")
    del data
    low = _reference(cell, st, device, dtype=torch.float32, tf32=True)
    return compare(low, _reference(cell, st, device))


# ---------------------------------------------------------------- faults
# planted in the program's timed path by loopsbench/calibrate.py (on the
# card) and the tests (on the CPU), to show the check fails on each


@contextlib.contextmanager
def unchanged_state():
    """A step that leaves the model's state unchanged."""
    with mock.patch.object(torch.optim.Adam, "step",
                           lambda self, closure=None: None):
        yield


@contextlib.contextmanager
def half_batch():
    """Half of the training rows left out, the mean taken over the
    rest."""
    from loops_tpu_torch.models import train

    plain = train.cross_entropy

    def half(logits, labels, mask=None):
        if mask is not None:
            rows = torch.nonzero(mask > 0)[:, 0]
            mask = mask.clone()
            mask[rows[::2]] = 0.0
        return plain(logits, labels, mask)

    with mock.patch.object(train, "cross_entropy", half):
        yield


@contextlib.contextmanager
def answer_altered():
    """The step's answer, its loss, altered by 0.1% where it is
    produced."""
    from loops_tpu_torch.models import train

    plain = train.cross_entropy

    def altered(logits, labels, mask=None):
        return plain(logits, labels, mask) * 1.001

    with mock.patch.object(train, "cross_entropy", altered):
        yield


@contextlib.contextmanager
def eval_altered():
    """The evaluation's answer, its accuracy, altered by 10% where it is
    produced."""
    from loops_tpu_torch.models import train

    plain = train.accuracy

    def altered(logits, labels, mask=None):
        return plain(logits, labels, mask) * 1.1

    with mock.patch.object(train, "accuracy", altered):
        yield


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "answer_altered": answer_altered, "eval_altered": eval_altered}
