"""Sharding rules (``sharding``) and the SPMD runtime of a bound mesh
(``spmd``): the port of ``repro.parallel``."""
