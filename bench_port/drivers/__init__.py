"""Traffic kinds: each module runs the mixes whose file names it as
``kind``.  ``setup(run, system, backend)`` builds the program (or what
``backend`` puts in its place) and warms up every shape the window uses;
``window(run, state)`` measures for ``run.seconds`` and returns (end-to-end
metrics, attempted, failed); ``release(state)`` frees the program;
``check(run, state, system)`` returns the numbers compared with the
reference."""
