"""job_s.host: `job_s` (the window's seconds over the jobs it completed)
in a cell whose host's pace sets the job time and swings it by ~10% a
job, so that it takes a bound of its own."""

from portbench.harness.files import metric_module

read = metric_module("job_s").read
