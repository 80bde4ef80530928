"""Hand-written Hopper kernels, one folder each: ``csrc/`` (CUDA C++),
``ops.py`` (the wrapper the model calls) and ``ref.py`` (the plain PyTorch
version, run for CPU tensors and held against the kernel on the card).

Each wrapper module counts its kernel launches in its ``launches``, which
readers read and set to 0 as a plain attribute, and the same launches by
card in ``card_launches`` ({CUDA device index: launches}), which readers
read and set to ``{}``. The runtime runs payloads in worker threads, where a
bare ``launches += 1`` (load, add, store) can lose counts, so every wrapper
adds through ``count_launch``."""
import sys
import threading

_count_lock = threading.Lock()


def count_launch(module: str, counter: str = "launches", card=None):
    """Add one to ``counter`` (``launches``, or a count of one kind of
    launch among them) of the wrapper module named ``module`` (its
    ``__name__``), and where ``card`` (a device index) is given one to that
    card's entry of its ``card_launches``, under a lock shared by the four
    wrappers."""
    mod = sys.modules[module]
    with _count_lock:
        setattr(mod, counter, getattr(mod, counter) + 1)
        if card is not None:
            by_card = mod.card_launches
            by_card[card] = by_card.get(card, 0) + 1
