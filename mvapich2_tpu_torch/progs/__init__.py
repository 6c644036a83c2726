"""Rank programs a user starts under ``mpirun``
(``python -m mvapich2_tpu_torch.run``): ``vpod_collectives.py`` (under
``--vpod``, on the card) and ``pingpong.py`` (process mode). Each is run
by its file path; ``chip_smoke.py``'s ``[mpirun]`` phase runs both."""
