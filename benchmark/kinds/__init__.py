"""The traffic kinds, one module each, found by the traffic file's `kind`
(`spec.Cell.kind`): the loop that drives the window, the check of what it
produced, the control and the faults planted in the program."""
