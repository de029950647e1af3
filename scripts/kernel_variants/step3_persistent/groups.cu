// Warpgroups a block: kWgMaxGroups share each K and V chunk, unless the
// blocks that gives would not fill the `slots` the card holds at once
int wgmma_groups(int seq, int rows_x_heads, int slots) {
  const int tiles = (seq + kWgRows - 1) / kWgRows;
  const long long blocks = (long long)rows_x_heads * ((tiles + kWgMaxGroups - 1) / kWgMaxGroups);
  return blocks < slots ? 1 : kWgMaxGroups;
}

