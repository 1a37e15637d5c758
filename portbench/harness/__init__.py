"""The benchmark's own machinery: finding a cell's files by name, drawing
weights and inputs from the seed, timing the window, reading the traced
slice, and the comparison that decides `correct`.  None of it is
specific to one configuration, traffic mix, entry or metric."""
