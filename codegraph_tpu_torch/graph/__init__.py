"""Graph store, CSR adjacency and the adjacency boost."""
