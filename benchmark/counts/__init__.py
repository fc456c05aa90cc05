"""The benchmark's yardstick: model FLOPs, the bytes each kernel must
move, and the card's published peaks. Kept with the benchmark so that no
change to the measured program can move them."""
