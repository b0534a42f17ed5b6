"""The plain reference that decides `correct`: straightforward float64
PyTorch written from the OCPs' published equations (`vendor/
usv_models.py`).  It imports nothing of the program and takes nothing
the program made except the answers it judges and, for an SQP-RTI tick,
the warm start the tick started from (an RTI tick is defined on it)."""
