"""The plain reference: what a node must flush for one interval of a
traffic plan, worked out in numpy from the plan's arrays alone
(``expected``), and the comparison of a flush against it (``compare``).

It imports numpy and the benchmark's plan, nothing of the program under
test, and takes nothing the program made."""
