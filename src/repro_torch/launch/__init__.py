"""Launchers of the port: process launch for the distributed engine
(``mesh``) and the solver service's CLI (``serve``)."""
