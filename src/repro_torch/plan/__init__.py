"""Plan IR, cost model, order search (numpy copies) and the executor."""
