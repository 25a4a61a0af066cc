"""The benchmark of ``melspec_tpu_torch``, the PyTorch and CUDA frontend.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell on the card and prints one JSON line.
Everything that belongs to one configuration, traffic kind, entry,
per-layer metric or kernel sits in a file of its own under this folder,
found by its name; ``run.py`` names none of them."""
