"""One driver a kind of program entry: it builds the program from the
cell's configuration and traffic, runs its first steps for the check,
runs a unit of the window, and hands the reference what it needs. A
driver is found by the name in the cell's file (``drivers/<kind>.py``)."""
