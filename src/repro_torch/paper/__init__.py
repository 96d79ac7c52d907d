"""The paper's figure and theorem drivers on the port (counterparts of the
reference's ``benchmarks/fig1_residual.py``, ``fig2_scaling.py``,
``fig3_async_penalty.py``, ``theory_validation.py`` and their runner
``run.py``).

Each is a module of the package, runnable as ``python -m
repro_torch.paper.<name> [--device cpu]``; ``python -m
repro_torch.paper.run [--only NAME] [--fast]`` runs the four.  They print
the reference's CSV-ish lines (``common.emit``) and write nothing to disk.
Every driver's ``run()`` takes the reference's arguments and defaults, runs
on the card unless given ``device="cpu"``, and draws its streams from
``torch.Generator`` objects seeded with the reference's integers: another
stream than the reference's threefry keys, so the tests hand the drivers
the reference's streams (``picks=``, ``delays=``) and its problem
(``problem=``).
"""
