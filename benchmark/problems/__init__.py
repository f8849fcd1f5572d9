"""The problems a configuration can name: one module a problem family.

A configuration file names its family under ``family`` (``"poisson7"``
when it has none; its ``problem`` key states the problem in prose);
``spec.load_problem`` loads
``benchmark/problems/<family>.py`` from the checkout's root, so a later
change adds a family by adding files.  The module gives two functions:

``build(config, device, precision=None) -> system.System``
    ``KSP`` with its operators set and its preconditioner built
    (``KSPSetOperators`` + ``KSPSetUp``) for ``config`` on ``device``;
    ``precision`` overrides the configuration's (``control.py`` builds the
    control so).  This is the program under test: it may import
    ``tpusparse_torch``.

``reference(config)``
    The plain reference that decides ``correct``: an object with
    ``.shape`` (nz, ny, nx), the shape of the right-hand sides the traffic
    makes, and ``.residual(x, b) -> (||b - A x||_2, ||b||_2)`` in float64
    for a solution ``x`` and its right-hand side ``b`` (fields or flat
    vectors in the grid's order).  It is written from the problem's
    statement in plain torch or NumPy, under ``benchmark/reference/``,
    and takes nothing from the program: it imports neither
    ``tpusparse_torch`` nor JAX nor ``tpusparse``, and reads the
    program's solution only to judge it.
"""
