"""The benchmark of ``p2p_bridge_tpu_torch`` on NVIDIA H100 cards.

  python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root names the cells, the metrics and
the configurations; everything that belongs to one of them lives in a file
of its own that the harness finds by name:

* ``configs/<config>.json``: the model configuration as it is run;
* ``traffic/<mix>.json``: the parameters of one traffic mix, read by the
  driver it names (``drivers/<driver>.py``);
* ``layers/<metric>.py``: the reader of one per-layer metric;
* ``limits/<cell>.json``: the limits of the numbers that decide ``correct``.

``reference/`` is the plain float32 PyTorch reference the outputs are held
to; it imports nothing of the program.
"""
