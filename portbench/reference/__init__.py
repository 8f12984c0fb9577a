"""Plain NumPy references of what the timed paths decide.

They import nothing of the program and take nothing that it made: each works
the engine's state out again from the generated inputs, op for op in the
float32 the configurations state (the cone threshold aside: see
``geometry.cone_band``). ``precision="bf16"`` is the control: the same
reference with its positions held in bfloat16, which the comparison must
refuse.
"""
