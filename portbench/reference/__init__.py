"""The plain PyTorch reference that decides ``correct``: the recipe's model,
criterion, optimizer and numpy postprocess, with no kernel and nothing
imported from the program."""
