"""The least time the card could take for a kernel's work, from the cell's
shapes (``counts``): the yardstick of the ``*_roofline`` metrics."""
