"""Frozen operation and byte counts, and the card's published peaks.

A configuration names its architecture with its ``reference`` key, and the
harness loads ``benchmark/cost/<arch>.py`` for it, which holds
``train_step_flops(model, frames, tokens)``: the useful operations of one
training step over utterances of so many feature frames and target tokens.
``roofline.py`` holds the peaks, the kernels' bounds and the counts the
architectures share."""
