"""The benchmark's yardstick for work: operations and bytes computed from
shapes, and the chip's published peaks. Frozen copies of the program's
own arithmetic, kept here so that a change to the program cannot move
them."""
