"""The plain reference that decides ``correct``: ``train_check`` for the
train cells, ``grid_check`` for the eval grid, over ``spacap``, a frozen
copy of the program's plain code. Nothing here imports the program."""
