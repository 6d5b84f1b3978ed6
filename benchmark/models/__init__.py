"""Model adapters, one file a model a configuration names (`"model"` in
its file), found by that name: `shapes`, `weights` (made from the seed),
`formats` (the Kronecker format pairs), `inputs` (one step's batch, rows
first), `tokens_per_step`, `program_loss` (the program's loss entry),
`reference_loss` (the plain reference's) and `forward_flops`."""
