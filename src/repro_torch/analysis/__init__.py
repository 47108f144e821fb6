"""Dry-run analysis (the port of `repro.analysis`): FLOP and collective
counters over a traced torch program (`op_cost`, `collectives`), the H100
roofline (`roofline`), and the JSON-to-Markdown renderings of a sweep
(`report`, `compare`)."""
