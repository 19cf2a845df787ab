"""The seconds of set-up's epochs (``Trainer.epoch_seconds`` summed over the
three checked one-step epochs and the warm-up epoch; host clock, each
ending in the epoch's read of its losses): cuDNN's search for each batch
width, conv5's first launch and, under ``epoch_scan``, the captures."""


def read(summary):
    return summary["setup_epochs_s"]
