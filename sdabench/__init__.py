"""The benchmark of the PyTorch and CUDA port (``sda_tpu_torch``).

Run one cell from the checkout's root::

    python3 -m sdabench --workload northstar.sumfirst --seed 7 --seconds 30 --trace 0

Everything is found by name from ``BENCHMARK.json``: a cell names a
configuration (``configs/<config>.json``, with the plain reference it names
under ``reference/``) and a traffic mix (``traffic/<mix>.json``, read by the
general loop it names under ``loops/``); every metric is a reader of its
own (``metrics/<metric>.py``). A later change adds a configuration, a mix or a
metric by adding files and entries, never by editing one.

The package imports ``torch``, numpy and the port. It never imports ``jax``
or the JAX package, and its reference (``reference/``) imports nothing of the
port either.
"""
