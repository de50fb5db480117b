"""The port's command-line entry points (counterparts of the repo's
``tools/train.py``, ``tools/test_vpq.py`` and ``tools/eval_vpq.py``); each
is run as ``python -m vps_torch.tools.<name>`` and has ``main(argv)`` for
callers in the same process."""
