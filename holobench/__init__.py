"""holobench: the benchmark of ``slmsuite_torch`` on the NVIDIA H100
(see ``README.md`` beside this file)."""
