"""The training loop and the evaluation pass.

Port of ``rnnt_tpu/train/loop.py``:

* ``evaluate`` — ``run_eval`` with the setup at ``:319-334``: for each eval
  batch, the exact eval loss (a pruned training objective is scored with
  the chunked exact loss), the eval forward and the batched greedy decode,
  then corpus WER against the references.
* ``train`` — ``train`` at ``:149-498``, on one process or on every rank
  of a ``torch.distributed`` process group (parallel/mesh.py): the
  augmentor chosen as at ``:173-203`` (host recipe, device recipe or both),
  the staging as at ``:280-318`` (the on-card corpus cache of
  data/device_cache.py under ``staging: auto`` or ``device`` when there is
  no host augmentor and the corpus fits its budget, else batches streamed
  from a ``BatchIterator`` with the data's worker pool behind a
  ``PrefetchIterator``), epochs in the cache's or the iterator's order
  (seed = epoch), the pruned-warmup switch by step, metrics to
  ``metrics.jsonl`` and stdout every ``log_steps``, TensorBoard histograms
  of the parameters every ``hist_steps`` (with tensorboardX), the NaN
  guard with its emergency checkpoint, periodic eval, asynchronous
  periodic checkpoints (``train/checkpoint.py``), a final checkpoint that
  waits, and the last WER returned; ``profile=True`` writes a
  torch.profiler trace of steps 3-6 (``trace/rank<r>.json.gz``, each step a
  ``step N`` span split into ``data``, the step's own ``train_step`` with
  its ``forward``, ``backward``, ``grad_norm`` and ``optimizer``, and
  ``bookkeeping``: the spans of ``train/profiling.py``).  Each step's
  record in ``metrics.jsonl`` also holds ``launches/<kernel>``, the
  hand-written kernels' launches in that step on rank 0 (0 on the CPU,
  where their plain versions run), ``conv_folds``, the dilated convs
  that step ran by phases (``ops/causal_conv.py`` ``FOLDS``), for a
  FastConformer ``attn_calls/<backend>``, the attention cores that step
  ran on that SDPA backend (``models/fastconformer.py`` ``ATTN_CALLS``,
  ``ATTN_BACKEND``), and on more
  than one rank
  ``launches_by_rank/<kernel>`` and
  ``total_norm_by_rank/train``, every rank's; an eval's record holds
  ``eval_launches/<kernel>``.

On more than one rank every rank caches the whole corpus on its own card
(the reference replicates its cache over the mesh,
``data/device_cache.py:19``, but downgrades an explicit ``staging:
device`` to streaming on multi-process runs, ``:295``; the port does not)
and takes its ``data`` rows of each global batch; or, streaming, loads
and host-augments only its data shard of the epoch (``stream_batches``,
as the reference shards per process, ``loop.py:465-474``): each rank of
a model group the same shard, each row with the same per-row
augmentation draws on any rank.  The shards bucket apart after
augmentation changes lengths, so their batch counts in an epoch differ:
every step the ranks agree in one all-reduce that each still has a
batch (and sum the global batch's audio seconds), and all end the epoch
when one has none (the reference has no such agreement).  Logging,
``metrics.jsonl``, evaluation and checkpoint saves happen on rank 0 with
barriers around them; a resume restores on every rank.

On a tensor-parallel mesh (``mesh.model`` > 1 without ``lattice_shard_t``)
every rank builds (or restores) the whole model and cuts it to its shards
(``parallel/mesh.shard_params``; the optimizer's moments follow), and says
how many parameters it holds; every ``loss_impl`` trains there, the
chunked loss through its vocabulary-sharded joint
(``parallel/partition.py``).  A save gathers every sharded parameter and
moment over the model group and rank 0 writes the whole model in the
unsharded layout, so a 1-rank ``cli.eval`` or resume reads it as it is,
once every rank's replicated parameters were found bit-equal; a resume
reads the whole model and cuts it again.  Rank 0's eval runs on the
gathered whole model (``parallel/mesh.whole_model``), not sharded.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from rnnt_tpu_torch.compat.jax_params import flatten_tree, to_jax
from rnnt_tpu_torch.config.config import (
    Config,
    build_featurizer_spec,
    build_model_spec,
    check_mesh,
    save_config,
)
from rnnt_tpu_torch.data.augment import build_augmentor, default_augmentor
from rnnt_tpu_torch.data.augment_device import (
    DEVICE_SIDE_KINDS,
    DEVICE_SIDE_KINDS_FULL,
    host_only_default_augmentor,
    warn_stripped_param_mismatch,
)
from rnnt_tpu_torch.data.dataset import (
    BatchIterator,
    Buckets,
    commonvoice_dataset,
    concatenate_rows,
    librispeech_dataset,
    synthetic_dataset,
    synthetic_piece_table,
)
from rnnt_tpu_torch.data.device_cache import DeviceSampleCache, gather_rows
from rnnt_tpu_torch.data.pipeline import PrefetchIterator
from rnnt_tpu_torch.data.tokenizer import UnigramTokenizer
from rnnt_tpu_torch.decode.greedy import greedy_decode
from rnnt_tpu_torch.models import fastconformer
from rnnt_tpu_torch.models.rnnt import RNNT, rnnt_init
from rnnt_tpu_torch.ops import causal_conv
from rnnt_tpu_torch.ops.kernels import launch_counts
from rnnt_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    make_mesh,
    replica_digests,
    shard_opt_state,
    shard_params,
    whole_model,
)
from rnnt_tpu_torch.train import checkpoint as ckpt
from rnnt_tpu_torch.train.metrics import wer
from rnnt_tpu_torch.train.optim import make_optimizer
from rnnt_tpu_torch.train.profiling import span, start_trace, stop_trace
from rnnt_tpu_torch.train.step import (
    TrainState,
    batch_to_device,
    make_eval_forward,
    make_loss_fn,
    make_train_step,
)
from rnnt_tpu_torch.utils import resolve_device


def _load_tokenizer(cfg: Config) -> UnigramTokenizer:
    if cfg.tokenizer.spm_model:
        return UnigramTokenizer.from_file(cfg.tokenizer.spm_model)
    if cfg.tokenizer.vocab_json:
        return UnigramTokenizer.from_vocab_json(cfg.tokenizer.vocab_json)
    if cfg.data.dataset == "synthetic":
        # The synthetic corpus's own pieces, padded to the text vocabulary.
        return UnigramTokenizer.from_table(synthetic_piece_table(cfg.num_text_tokens))
    raise ValueError("config.tokenizer needs spm_model or vocab_json (a synthetic "
                     "corpus uses its own pieces when neither is set)")


def _load_datasets(cfg: Config):
    """(train, eval) row datasets: the synthetic corpus, or Hugging Face
    librispeech / commonvoice splits.  A split may name its corpus
    (``"commonvoice:train"``, ``"librispeech:train.clean.100"``), as the
    mixed fullcausal recipe does; an unprefixed split is
    ``data.dataset``'s."""
    dc = cfg.data
    if dc.dataset == "synthetic":
        train = synthetic_dataset(dc.synthetic_size, dc.synthetic_seconds,
                                  seed=0, max_words=dc.synthetic_max_words)
        if dc.eval_on_train:
            return train, train
        evals = synthetic_dataset(max(dc.synthetic_size // 8, 8),
                                  dc.synthetic_seconds, seed=1,
                                  max_words=dc.synthetic_max_words)
        return train, evals
    if dc.dataset not in ("librispeech", "commonvoice"):
        raise ValueError(f"unknown dataset {dc.dataset}")

    def load(split: str):
        corpus, _, name = split.rpartition(":")
        corpus = corpus or dc.dataset
        if corpus == "librispeech":
            return librispeech_dataset([name], dc.cache_dir)
        if corpus == "commonvoice":
            return commonvoice_dataset(name, dc.cache_dir)
        raise ValueError(f"unknown corpus prefix {corpus!r} in split {split!r}")

    train = concatenate_rows([load(s) for s in dc.train_splits])
    evals = train if dc.eval_on_train else load(dc.eval_split)
    return train, evals


def eval_batches(cfg: Config, tokenizer: UnigramTokenizer, *,
                 batch_size: int | None = None,
                 max_batches: int | None = None) -> BatchIterator:
    """The eval stream ``evaluate`` scores by default."""
    tc = cfg.training
    fspec = build_featurizer_spec(cfg)
    _, eval_ds = _load_datasets(cfg)
    bs = batch_size or tc.global_batch_size
    return BatchIterator(
        eval_ds, tokenizer,
        Buckets.from_frames(tc.frame_buckets, tc.token_buckets, fspec),
        batch_size=bs, shuffle=False, drop_last=False,
        max_batches=max_batches or max(tc.eval_max_elements // bs, 1),
        wire_dtype=cfg.data.wire_dtype)


def evaluate(cfg: Config, model: RNNT, *, device=None, batches=None,
             batch_size: int | None = None,
             max_batches: int | None = None) -> dict:
    """Score ``model`` (already on ``device``) on the eval stream, or on the
    given numpy ``batches``.  Runs on CUDA unless ``device="cpu"``.

    Returns {"nll": mean exact NLL over batches, "wer", "utterances",
    "audio_seconds", "seconds", "loss_seconds", "decode_seconds"}: wall
    seconds of the whole pass, of the exact loss (featurize, encoder,
    predictor, joint and lattice) and of eval forward + greedy decode.
    Each phase ends by reading its result on the host, which waits for the
    card, so the phase times need no extra synchronization."""
    dev = resolve_device(device)
    tc = cfg.training
    spec = build_model_spec(cfg)
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    if batches is None:
        batches = eval_batches(cfg, tokenizer, batch_size=batch_size,
                               max_batches=max_batches)
    eval_forward = make_eval_forward(spec, fspec, tc.precision)
    exact_spec = (dataclasses.replace(spec, loss_impl="chunked")
                  if spec.loss_impl == "pruned" else spec)
    eval_loss = make_loss_fn(exact_spec, fspec, tc.precision)
    max_tokens = max(tc.token_buckets)

    originals, decoded, losses = [], [], []
    audio_seconds = loss_seconds = decode_seconds = 0.0
    t0 = time.time()
    with torch.inference_mode():
        for eb in batches:
            sb = batch_to_device(eb, dev)
            t_loss = time.time()
            losses.append(float(eval_loss(model, sb)))
            t_decode = time.time()
            loss_seconds += t_decode - t_loss
            audio, t_lens = eval_forward(model, sb)
            tokens, counts = greedy_decode(
                model.predictor, model.joint, audio, t_lens, spec.predictor,
                spec.joint, max_tokens=max_tokens)
            tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
            decode_seconds += time.time() - t_decode
            audio_seconds += float(np.sum(eb["audio_lens"])) / fspec.sample_rate
            for i in range(len(counts)):
                if eb["target_lens"][i] == 0:
                    continue
                originals.append(tokenizer.decode(
                    eb["targets"][i, : eb["target_lens"][i]]))
                decoded.append(tokenizer.decode(tokens[i, : counts[i]]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"nll": float(np.mean(losses)) if losses else float("nan"),
            "wer": wer(originals, decoded) if originals else float("nan"),
            "utterances": len(originals), "audio_seconds": audio_seconds,
            "seconds": time.time() - t0, "loss_seconds": loss_seconds,
            "decode_seconds": decode_seconds}


class MetricsLogger:
    """metrics.jsonl (and TensorBoard when tensorboardX is installed)."""

    def __init__(self, output_dir: Path):
        self.writer = None
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(logdir=str(output_dir))
        except ImportError:
            pass
        self.jsonl = open(output_dir / "metrics.jsonl", "a")

    def log(self, step: int, scalars: dict) -> None:
        if self.writer is not None:
            for k, v in scalars.items():
                if not isinstance(v, list):  # per-rank lists: the JSON only
                    self.writer.add_scalar(k, v, step)
        self.jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self.jsonl.flush()

    def log_histograms(self, step: int, model: RNNT, prefix: str = "weights") -> None:
        """A TensorBoard histogram of every parameter, tagged with its JAX
        pytree path (``weights/encoder/blocks/0/...``, as the JAX package
        tags it), so one TensorBoard reads both packages' runs; nothing
        without tensorboardX."""
        if self.writer is None:
            return
        params, _ = to_jax(model)
        for name, leaf in flatten_tree(params).items():
            self.writer.add_histogram(f"{prefix}/{name}", np.asarray(leaf).ravel(), step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self.jsonl.close()


def stream_batches(cfg: Config, train_ds, tokenizer, buckets, augmentor, epoch: int,
                   mesh: Mesh) -> BatchIterator:
    """The streamed batches of this rank in one epoch: its data shard
    (``shard_id`` = its data rank of ``mesh.data``, the same on every rank
    of its model group, which needs the same rows) of the epoch's order, in
    batches of ``global_batch_size / mesh.data`` rows, loaded and
    host-augmented here only, as the JAX package shards per process."""
    return BatchIterator(train_ds, tokenizer, buckets,
                         batch_size=cfg.training.global_batch_size // mesh.data,
                         augmentor=augmentor, shuffle=True, seed=epoch,
                         num_workers=cfg.data.num_workers,
                         worker_mode=cfg.data.worker_mode,
                         shard_id=mesh.data_rank, num_shards=mesh.data,
                         wire_dtype=cfg.data.wire_dtype)


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The generator of one step (augmentation draws, then dropout), on
    ``device``: seeded from the run seed and the step (the reference folds
    the step into its key), so a resumed run draws what an uninterrupted
    one would."""
    return torch.Generator(device=device).manual_seed(
        (42 + 1009 * seed) * 1_000_003 + step)


def _barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        dist.barrier()


def _from_main(mesh: Mesh, value):
    """Rank 0's ``value`` on every rank."""
    if mesh.world == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def select_augmentor(cfg: Config, make_augmentor=None):
    """The host augmentor of a run (None for none), as the reference picks
    it: the ``make_augmentor`` hook; else the ``data.augmentations`` list,
    without the kinds the device recipe runs when ``data.augment_device`` is
    on (a warning for each stripped op whose settings differ); else nothing
    on the host under ``augment_device: full``, the length-changing ops
    under ``augment_device: true``, the whole default recipe otherwise."""
    dc = cfg.data
    if not dc.augment:
        return None
    if make_augmentor is not None:
        return make_augmentor(cfg)
    full = dc.augment_device == "full"
    if dc.augmentations:
        aug_cfgs = dc.augmentations
        if dc.augment_device:
            skip = DEVICE_SIDE_KINDS_FULL if full else DEVICE_SIDE_KINDS
            warn_stripped_param_mismatch(
                [c for c in aug_cfgs if c.get("kind") in skip])
            aug_cfgs = [c for c in aug_cfgs if c.get("kind") not in skip]
        return build_augmentor(aug_cfgs) if aug_cfgs else None
    if full:
        return None
    if dc.augment_device:
        return host_only_default_augmentor()
    return default_augmentor()


def build_cache(cfg: Config, train_ds, tokenizer, buckets, fspec, augmentor,
                device, log=print) -> DeviceSampleCache | None:
    """The on-card corpus cache the run trains from, or None to stream:
    ``staging: auto`` caches when there is no host augmentor and the
    corpus fits ``device_cache_budget_mb``; ``device`` insists (raises with
    a host augmentor or over the budget); ``stream`` never caches."""
    dc = cfg.data
    if dc.staging not in ("auto", "stream", "device"):
        raise ValueError(f"data.staging must be auto|stream|device, "
                         f"got {dc.staging!r}")
    if dc.staging == "device" and augmentor is not None:
        raise ValueError("data.staging: device requires no host-side "
                         "augmentation (set data.augment_device: full "
                         "or data.augment: false)")
    if dc.staging == "stream" or augmentor is not None:
        return None
    cache = DeviceSampleCache.build(
        train_ds, tokenizer, buckets, wire_dtype=dc.wire_dtype,
        budget_bytes=dc.device_cache_budget_mb << 20,
        sample_rate=fspec.sample_rate, num_workers=dc.num_workers,
        device=device)
    if cache is None:
        if dc.staging == "device":
            raise ValueError(f"data.staging: device — corpus exceeds "
                             f"device_cache_budget_mb={dc.device_cache_budget_mb}")
        log("note: corpus exceeds device_cache_budget_mb; streaming batches")
    else:
        log(f"device sample cache: {cache.n_samples} samples, "
            f"{cache.nbytes() / 2**20:.1f} MiB on {device}")
    return cache


def train(cfg: Config, *, output_base: str | Path = "experiments",
          resume: str | None = None, max_steps: int | None = None,
          device=None, make_augmentor=None, profile: bool = False) -> float:
    """Train per ``cfg`` on this rank's card (CUDA unless ``device="cpu"``);
    return the last eval WER.

    Every ``data.augment`` / ``augment_device`` / ``staging`` /
    ``training.spec_augment`` setting runs as in the reference;
    ``make_augmentor(cfg)``, when given, builds the host augmentor.  The
    ``mesh`` section lays the ranks of the initialised process group (one
    rank without one) out as data x model; a mesh that does not match the
    group, and an unknown dataset, raise.  Rank 0 writes
    ``<output_base>/<model>/run-N`` with config.yaml, metrics.jsonl and
    ``checkpoint_step_<step>`` directories; ``profile`` adds ``trace/``."""
    dev = resolve_device(device)
    mesh = make_mesh(cfg.mesh.data, cfg.mesh.model)
    check_mesh(cfg, mesh.data, mesh.model)
    is_main = mesh.is_main
    say = print if is_main else (lambda *a, **k: None)
    tc = cfg.training
    spec = build_model_spec(cfg)
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    train_ds, _ = _load_datasets(cfg)
    buckets = Buckets.from_frames(tc.frame_buckets, tc.token_buckets, fspec)
    augmentor = select_augmentor(cfg, make_augmentor)
    device_augment = cfg.data.augment and cfg.data.augment_device
    cache = build_cache(cfg, train_ds, tokenizer, buckets, fspec, augmentor, dev,
                        log=say)

    output_dir = _from_main(mesh, ckpt.next_run_dir(output_base, cfg.model_name)
                            if is_main else None)
    if is_main:
        save_config(cfg, output_dir / "config.yaml")
    say(f"Output directory: {output_dir}"
        + (f" ({mesh.world} ranks: data {mesh.data} x model {mesh.model}, "
           f"{mesh.backend})" if mesh.world > 1 else ""))
    steps_per_epoch = max(len(train_ds) // tc.global_batch_size, 1)
    total_steps = tc.total_steps or steps_per_epoch * tc.num_epochs
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)

    optimizer, sched = make_optimizer(tc, total_steps)
    model = rnnt_init(spec, seed=tc.seed, device=dev)
    for k in ("encoder", "predictor", "joint"):
        n = sum(p.numel() for p in getattr(model, k).parameters())
        say(f"Number of {k} parameters: {n:,}")
    opt_state, step = None, 0
    if resume:
        opt_state, step = ckpt.restore(resume, model)
        say(f"Resumed from {resume} at step {step}")
    if mesh.model > 1 and not tc.lattice_shard_t:
        layout = shard_params(model, mesh)
        if opt_state is not None:
            opt_state = shard_opt_state(opt_state, layout, mesh)
        params = dict(model.named_parameters())
        held = sum(p.numel() for p in params.values())
        say(f"tensor parallel over {mesh.model} model ranks: {len(layout)} tensors "
            f"sharded ({sum(params[n].numel() for n in layout):,} parameters on each "
            f"rank); each rank holds {held:,} parameters")
    if opt_state is None:
        opt_state = optimizer.init(dict(model.named_parameters()))
    state = TrainState(model, opt_state, step)

    step_fn = make_train_step(spec, fspec, optimizer, tc.precision,
                              spec_augment=tc.spec_augment,
                              device_augment=device_augment, mesh=mesh)
    # k2-style pruned warmup: the exact loss (+ simple heads) for the first
    # pruned_warmup_steps, then the banded loss; chosen by step, so resume
    # picks the right one.
    warm_fn, warmup_until = None, 0
    if spec.loss_impl == "pruned" and tc.pruned_warmup_steps > 0:
        warmup_until = tc.pruned_warmup_steps
        warm_fn = make_train_step(
            dataclasses.replace(spec, loss_impl="pruned_warmup"), fspec,
            optimizer, tc.precision, spec_augment=tc.spec_augment,
            device_augment=device_augment, mesh=mesh)

    logger = MetricsLogger(output_dir) if is_main else None
    last_wer = float("nan")
    pending: list = []  # (step, metrics, kernel launches, (conv folds, attention cores))
    t_log = time.time()
    audio_secs = 0.0

    def flush(epoch: int) -> None:
        nonlocal pending, t_log, audio_secs
        if not pending:
            return
        last_loss = float(pending[-1][1]["loss"])  # waits for the card
        dt = time.time() - t_log
        if not np.isfinite(last_loss):  # the same loss on every rank
            write(state)
            raise FloatingPointError(
                f"non-finite loss {last_loss} at step {pending[-1][0]}; "
                f"emergency checkpoint saved to {output_dir}")
        mine = [dict(launched, grad_norm=float(m["grad_norm"])) for _, m, launched, _ in pending]
        by_rank = [mine]
        if mesh.world > 1:
            by_rank = [None] * mesh.world
            dist.all_gather_object(by_rank, mine)
        if not is_main:
            pending, audio_secs, t_log = [], 0.0, time.time()
            return
        for i, (s, m, launched, folds) in enumerate(pending):
            scalars = {"loss/train": float(m["loss"]),
                       "total_norm/train": float(m["grad_norm"]),
                       "learning_rate": sched(s - 1),
                       "input_length/train": int(m["total_target_len"]),
                       "epoch": epoch}
            scalars.update({f"total_norm/{k.split('/', 1)[1]}": float(v)
                            for k, v in m.items() if k.startswith("grad_norm/")})
            scalars.update({f"launches/{k}": n for k, n in launched.items()})
            scalars["conv_folds"], attn = folds
            if attn:
                scalars[f"attn_calls/{fastconformer.ATTN_BACKEND}"] = attn
            if mesh.world > 1:
                scalars.update({f"launches_by_rank/{k}": [r[i][k] for r in by_rank]
                                for k in launched})
                scalars["total_norm_by_rank/train"] = [r[i]["grad_norm"] for r in by_rank]
            logger.log(s, scalars)
        sps = len(pending) / dt if dt > 0 else 0.0
        asps = audio_secs / dt if dt > 0 else 0.0
        print(f"step {pending[-1][0]}: loss={last_loss:.3f} "
              f"grad_norm={float(pending[-1][1]['grad_norm']):.3f} "
              f"{sps:.2f} steps/s {asps:.1f} audio-s/s")
        logger.log(pending[-1][0], {"steps_per_sec": sps,
                                    "audio_seconds_per_sec": asps,
                                    "step_seconds": dt / len(pending)})
        pending, audio_secs, t_log = [], 0.0, time.time()

    def run_eval() -> None:
        """Rank 0 scores the whole model (gathered from its shards on a
        tensor-parallel mesh) while the others wait; then every rank takes
        rank 0's WER."""
        nonlocal last_wer, t_log
        _barrier(mesh)
        with whole_model(model, mesh):
            if is_main:
                before = launch_counts()
                model.eval()
                res = evaluate(cfg, model, device=dev, batch_size=tc.global_batch_size)
                model.train()
                if res["utterances"]:
                    last_wer = res["wer"]
                    logger.log(state.step, {
                        "wer/eval": last_wer, "loss/eval_exact": res["nll"],
                        **{f"eval_launches/{k}": n - before[k]
                           for k, n in launch_counts().items()}})
                    print(f"eval wer at step {state.step}: {last_wer:.4f} "
                          f"(exact nll {res['nll']:.3f})")
        last_wer = _from_main(mesh, last_wer)
        t_log = time.time()

    def write(st: TrainState, wait: bool = True) -> None:
        """Rank 0 writes the whole state: on a tensor-parallel mesh every
        rank takes part in gathering the shards first, after checking that
        the replicated parameters rank 0 writes are every rank's.  With
        ``wait=False`` rank 0's disk writes run on a background thread once
        its host copy is taken (train/checkpoint.py)."""
        if getattr(st.model, "tp_layout", {}):
            digests = replica_digests(st.model, mesh)
            if len(set(digests)) != 1:
                raise RuntimeError(f"replicated parameters differ across the ranks at "
                                   f"step {st.step}: digests {digests}")
            say(f"replicated parameters bit-equal on the {mesh.world} ranks at step "
                f"{st.step} (digest {digests[0]:#x})")
        with whole_model(st.model, mesh, st.opt_state) as whole_opt:
            if is_main:
                ckpt.save(output_dir, TrainState(st.model, whole_opt, st.step), cfg,
                          wait=wait)

    def save(wait: bool = True) -> None:
        _barrier(mesh)
        write(state, wait)
        _barrier(mesh)

    # TensorBoard histograms on rank 0 (every rank gathers a sharded model).
    histograms = is_main and logger.writer is not None
    if mesh.model > 1 and not tc.lattice_shard_t:
        histograms = _from_main(mesh, histograms)

    def log_histograms() -> None:
        with whole_model(model, mesh):
            if is_main:
                logger.log_histograms(state.step, model)

    rows = mesh.rows(tc.global_batch_size // mesh.data)

    def epoch_batches(epoch: int):
        """(this rank's rows of a global batch on the device, the global
        batch's audio seconds) of one epoch: rows gathered from the cache
        in its order, or this rank's shard streamed."""
        if cache is not None:
            for gi, idx in cache.epoch_batches(tc.global_batch_size, seed=epoch):
                yield (gather_rows(cache.groups[gi], idx[rows]),
                       cache.batch_audio_seconds(gi, idx))
            return
        it = stream_batches(cfg, train_ds, tokenizer, buckets, augmentor, epoch, mesh)
        batches = iter(PrefetchIterator(it, depth=4))
        n = 0
        try:
            while True:
                batch = next(batches, None)
                secs = 0.0 if batch is None else (
                    float(batch["audio_lens"].sum()) / fspec.sample_rate)
                if mesh.world > 1:
                    # Shards bucket apart, so their batch counts differ: the
                    # ranks agree each step that all still have a batch, and
                    # sum the global batch's audio seconds, in one all-reduce.
                    both = all_reduce_sum(torch.tensor(
                        [float(batch is not None), secs], dtype=torch.float64, device=dev))
                    if int(both[0]) < mesh.world:
                        return
                    secs = float(both[1]) / mesh.model
                elif batch is None:
                    return
                n += 1
                yield batch_to_device(batch, dev), secs
        finally:
            if mesh.world > 1:
                print(f"rank {mesh.rank} (data shard {mesh.data_rank} of {mesh.data}): "
                      f"epoch {epoch}: {it.rows_loaded} rows loaded and host-augmented, "
                      f"{n} batches of {it.batch_size} rows", flush=True)

    def stop_profile() -> None:
        nonlocal prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        path = stop_trace(prof, output_dir / "trace", f"rank{mesh.rank}")
        prof = None
        say(f"profiler trace of steps {start_step + 3}-{state.step} written to {path}")

    model.train()
    prof = None
    start_step = state.step
    done = state.step >= total_steps
    for epoch in range(max(tc.num_epochs, 1)):
        if done:
            break
        batches = epoch_batches(epoch)
        while not done:
            if profile and prof is None and state.step - start_step == 2:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof = start_trace(dev)  # steps 3-6 of this run
            with span(f"step {state.step + 1}", step=state.step):
                with span("data"):
                    item = next(batches, None)
                if item is None:
                    break
                batch, seconds = item
                fn = warm_fn if warm_fn is not None and state.step < warmup_until else step_fn
                before = launch_counts()
                folds, attn = causal_conv.FOLDS, fastconformer.ATTN_CALLS
                state, metrics = fn(state, batch, step_generator(dev, tc.seed, state.step))
                launched = {k: n - before.get(k, 0) for k, n in launch_counts().items()}
                folds = (causal_conv.FOLDS - folds, fastconformer.ATTN_CALLS - attn)
                with span("bookkeeping"):
                    audio_secs += seconds
                    pending.append((state.step, metrics, launched, folds))
                    if state.step % tc.log_steps == 0:
                        flush(epoch)
                    if state.step % tc.eval_steps == 0 or state.step == total_steps:
                        flush(epoch)
                        run_eval()
                    if state.step % tc.hist_steps == 0 and histograms:
                        log_histograms()
                    if state.step % tc.checkpoint_steps == 0:
                        save(wait=False)
                    done = state.step >= total_steps
            if prof is not None and state.step - start_step == 6:
                stop_profile()
        batches.close()

    if prof is not None:
        stop_profile()
    flush(max(tc.num_epochs, 1) - 1)
    if np.isnan(last_wer):
        run_eval()
    save()  # waits, after any periodic save still being written
    if logger is not None:
        logger.close()
    return last_wer
