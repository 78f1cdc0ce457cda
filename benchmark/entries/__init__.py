"""Entries into the program, one file each, found by the ``entry`` name of
a traffic file. Each has ``prepare(system, cfg, device)`` (imports the
program and builds what every fit shares) and ``fit(state, coords, forces,
rng)``, which makes one call a user would make and returns a dict with the
outputs the check judges: ``mapped`` (T, S, 3) mapped forces on the
device, and ``coefs`` (per-site featurized coefficients), ``fmap`` (an (S,
N) linear map) or ``constraints`` (detected pairs) where the entry has
them, and ``escalated_sites``, the sites whose solve went to the float64
host solver. Calls are wrapped in ``torch.profiler.record_function`` spans
named ``bench.<call>``."""
