"""The plain references the benchmark judges the program by, one module a
kind of unit (``restir``: the ReSTIR frame), each written apart from the
program and importing nothing of it. They take the scene from the
configuration's arrays (``harness.scenedata``) and make the program's
random numbers again from the seed (``philox`` for the kernels' streams);
``precision`` runs them one precision below the cell's (the control)."""
