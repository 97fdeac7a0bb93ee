"""The plain reference: float32 PyTorch with TF32 off, written from the
models' published description and independent of the program under test
(it imports nothing of it).

A configuration names its architecture with its ``reference`` key, and the
harness loads ``benchmark/reference/<arch>.py`` for it, which holds

* ``num_frames(samples, featurizer)``: an utterance's feature frames;
* ``encoder_out_len(frames, model)``: the encoder's output frames;
* ``rows_nll(P, model, wave, lens, targets, target_lens, quant=None)``:
  a block of rows (float32 waves, the int16 wire rows over their scale;
  samples; target ids; target counts) to each row's NLL, differentiable in
  the parameters ``P``, with ``quant`` rounding every product's operands.

``common.py`` holds what the architectures share: the featurizers, both
predictors, the joint, the lattice's NLL and AdamW.
"""
