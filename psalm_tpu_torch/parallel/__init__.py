"""Distribution: the ('data', 'model') process groups, the tensor-parallel
rules, the processes that run them and the multi-card dry run."""
