"""One driver a port entry point that a window drives: ``setup(cell, seed,
device)``, ``window(state, win, spans)``, ``check(state, records)``, and
``control(state)``, which puts the check's control in the program's place
after set-up."""
