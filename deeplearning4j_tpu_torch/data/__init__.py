"""Host-side data containers and iterators (numpy), as in the JAX
package."""
