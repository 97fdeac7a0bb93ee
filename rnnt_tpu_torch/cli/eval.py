"""Eval CLI: ``python -m rnnt_tpu_torch.cli.eval <checkpoint_dir>``.

Port of ``rnnt_tpu/cli/eval.py``: load the checkpoint directory
(``config.yaml`` + ``params.npz``, compat/jax_params.py) or an explicit
``--config``, decode the eval set under ``torch.inference_mode``, print
each original/decoded pair, the corpus WER and the wall time per sample.
Greedy decode by default; ``--beam N`` runs beam search of width N
(decode/beam.py, its defaults); with ``--rescore`` each utterance's
hypothesis is the candidate of least exact NLL among the final beam and
the greedy chain (decode/rescore.py, the loss's ``loss_chunk_size``).
Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from rnnt_tpu_torch.compat.jax_params import find_config, load_checkpoint
from rnnt_tpu_torch.config.config import build_featurizer_spec, build_model_spec, load_config
from rnnt_tpu_torch.decode.beam import beam_decode, beam_decode_nbest
from rnnt_tpu_torch.decode.greedy import greedy_decode
from rnnt_tpu_torch.decode.rescore import marginal_rescore
from rnnt_tpu_torch.models.rnnt import refuse_unsupported
from rnnt_tpu_torch.train.loop import _load_tokenizer, eval_batches
from rnnt_tpu_torch.train.metrics import wer
from rnnt_tpu_torch.train.step import batch_to_device, make_eval_forward
from rnnt_tpu_torch.utils import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="checkpoint directory")
    ap.add_argument("--config", default=None,
                    help="config yaml (default: next to checkpoint)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-elements", type=int, default=200)
    ap.add_argument("--beam", type=int, default=0,
                    help="beam width (0 = greedy decode)")
    ap.add_argument("--rescore", action="store_true",
                    help="with --beam: pick each utterance's hypothesis from the "
                         "final beam (+ greedy candidate) by the exact "
                         "sum-over-alignments NLL (decode/rescore.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config(args.config or find_config(args.checkpoint))
    spec = build_model_spec(cfg)
    if args.beam > 0:
        refuse_unsupported(spec, "beam search (cli.eval --beam)")
    fspec = build_featurizer_spec(cfg)
    tokenizer = _load_tokenizer(cfg)
    model = load_checkpoint(args.checkpoint, spec, dev)
    it = eval_batches(cfg, tokenizer, batch_size=args.batch_size,
                      max_batches=max(args.max_elements // args.batch_size, 1))
    eval_forward = make_eval_forward(spec, fspec, cfg.training.precision)
    max_tokens = max(cfg.training.token_buckets)
    dec = (model.predictor, model.joint)
    specs = (spec.predictor, spec.joint)

    def decode(audio, t_lens):
        if args.beam > 0 and args.rescore:
            toks, cnts, _ = beam_decode_nbest(*dec, audio, t_lens, *specs,
                                              beam_width=args.beam, max_tokens=max_tokens)
            return marginal_rescore(*dec, audio, t_lens, toks, cnts, *specs,
                                    chunk_size=cfg.training.loss_chunk_size)[:2]
        if args.beam > 0:
            return beam_decode(*dec, audio, t_lens, *specs, beam_width=args.beam,
                               max_tokens=max_tokens)[:2]
        return greedy_decode(*dec, audio, t_lens, *specs, max_tokens=max_tokens)

    originals, decoded = [], []
    t0 = time.time()
    with torch.inference_mode():
        for batch in it:
            audio, t_lens = eval_forward(model, batch_to_device(batch, dev))
            tokens, counts = decode(audio, t_lens)
            tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
            for i in range(len(counts)):
                if batch["target_lens"][i] == 0:
                    continue
                orig = tokenizer.decode(
                    batch["targets"][i, : batch["target_lens"][i]])
                hyp = tokenizer.decode(tokens[i, : counts[i]])
                print(f"\nOriginal: {orig}\nDecoded : {hyp}")
                originals.append(orig)
                decoded.append(hyp)
    dt = time.time() - t0
    n = len(originals)
    score = wer(originals, decoded)
    print(f"\nWER: {score:.4f}")
    print(f"Total time: {dt:.2f}s, {dt / max(n, 1):.3f}s per sample")
    return {"wer": score, "utterances": n, "seconds": dt}


if __name__ == "__main__":
    main()
