"""The benchmark of the PyTorch and CUDA port (``xvc_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  The package holds the yardstick: the load
generator (``load.py``) and its client processes (``client.py``), the
arithmetic (``stats.py``), the reading of traces (``trace.py``), the
peaks (``peaks.py``), the plain reference decoder and the work its
pictures need (``reference/``, its pictures and work recorded under
``data/``), the comparison that decides ``correct`` (``correct.py``),
one file for each configuration (``configs/``) and traffic mix
(``traffic/``), and one reader for each family of per-layer metrics
(``metrics/``); ``control.py``, ``faults.py`` and ``sweep.py`` are the
readings that set the limits of ``correct`` and a live mix's rate.  It
takes from the program only ``xvc_tpu_torch.api.DecoderSession`` and the
spans and trace of ``xvc_tpu_torch.profiling``, in the client
processes.
"""
