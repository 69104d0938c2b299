"""The yardstick of a packed polynomial evaluated at inputs, which every
configuration without a ``yardstick`` key takes: its inputs are
``inputs.make``'s (the packed values of each rank, a bias, a pool of x),
and ``correct`` is ``check.compare``'s, every result of the window against
the plain float64 reference (``reference/poly.py``) at the row it used.
The control puts that reference, in the workload's lower precision
(``control``), in the program's place at the same rows."""

from portbench import check, inputs


def draw(config: dict, dtype: str, pool_rows: int, seed: int, device):
    return inputs.make(config, dtype, pool_rows, seed, device)


def compare(workload: dict, record, made):
    return check.compare(workload, record.all_rows(), record.all_results(), made)


def control(workload: dict, record, made):
    rows = record.all_rows()
    return check.compare(workload, rows, check.control_results(workload, rows, made), made)
